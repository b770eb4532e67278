"""Train ResNet50 on synthetic data — estimator-style front-end: the
port's twin of ``examples/imagenet_estimator_tpu.py``, the counterpart
of the reference's ``HorovodTF/src/imagenet_estimator_tf_horovod.py``:
the same env-var contract (docstring there, :1-9 — ``DISTRIBUTED``,
``FAKE``, ``FAKE_DATA_LENGTH``, ``EPOCHS``, ``VALIDATION``,
``AZ_BATCHAI_OUTPUT_MODEL``), the same mainline shape (main()
:413-455), one engine underneath.

Run on the card (the reference's ``mpirun -np 2`` smoke, SURVEY.md
§4.2, is two processes with the ``DDL_*`` variables)::

    FAKE=True FAKE_DATA_LENGTH=2048 EPOCHS=1 BATCHSIZE=32 \\
        python -m distributeddeeplearning_tpu_torch.examples.imagenet_estimator

``DDL_PLATFORM=cpu`` runs it on the CPU.
"""

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import make_input_fn
from distributeddeeplearning_tpu_torch.frontends import Estimator, RunConfig
from distributeddeeplearning_tpu_torch.parallel import distributed
from distributeddeeplearning_tpu_torch.utils.logging import get_logger


def main():
    distributed.maybe_initialize()  # hvd.init() equivalent (:417)
    config = TrainConfig.from_env(model="resnet50")
    logger = get_logger()
    logger.info("Estimator-style training: %s", config)

    estimator = Estimator(
        config.model,
        config,
        RunConfig(model_dir=config.model_dir, device=distributed.default_device()),
    )
    estimator.train(make_input_fn(train=True), epochs=config.epochs)
    if config.validation:
        metrics = estimator.evaluate(make_input_fn(train=False))
        logger.info("validation: %s", metrics)


if __name__ == "__main__":
    main()

"""Train ResNet50 — Keras-style front-end with the full callback set:
the port's twin of ``examples/imagenet_keras_tpu.py``, the counterpart
of the reference's ``HorovodKeras/src/imagenet_keras_horovod.py``:
compile/fit with the callback roster the reference assembles at
:194-227 — broadcast, metric averaging, 5-epoch LR warmup, x0.1 decay at
30/60/80 (arXiv:1706.02677, cited there at :40-42), per-epoch logger,
rank-0 checkpointing with resume (:287-291, :316-341).

Run on the card::

    FAKE=True FAKE_DATA_LENGTH=2048 EPOCHS=1 BATCHSIZE=32 \\
        python -m distributeddeeplearning_tpu_torch.examples.imagenet_keras

``DDL_PLATFORM=cpu`` runs it on the CPU; ``DDL_COORDINATOR``,
``DDL_NUM_PROCESSES`` and ``DDL_PROCESS_ID`` form a multi-process world.
"""

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import make_dataset
from distributeddeeplearning_tpu_torch.frontends import Model
from distributeddeeplearning_tpu_torch.parallel import distributed
from distributeddeeplearning_tpu_torch.training.callbacks import (
    BroadcastGlobalVariablesCallback,
    LearningRateScheduleCallback,
    LearningRateWarmupCallback,
    LoggerCallback,
    MetricAverageCallback,
    ModelCheckpointCallback,
)
from distributeddeeplearning_tpu_torch.utils.logging import get_logger


def main():
    distributed.maybe_initialize()
    config = TrainConfig.from_env(model="resnet50")
    logger = get_logger()
    logger.info("Keras-style training: %s", config)

    model = Model(config.model, config, device=distributed.default_device())
    model.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")

    callbacks = [
        # Reference callback roster (imagenet_keras_horovod.py:194-227):
        BroadcastGlobalVariablesCallback(0),
        MetricAverageCallback(),
        LearningRateWarmupCallback(warmup_epochs=config.warmup_epochs, verbose=True),
        LearningRateScheduleCallback(multiplier=0.1, start_epoch=30),
        LearningRateScheduleCallback(multiplier=0.01, start_epoch=60),
        LearningRateScheduleCallback(multiplier=0.001, start_epoch=80),
        LoggerCallback(),
    ]
    if config.model_dir:
        callbacks.append(ModelCheckpointCallback(config.model_dir))

    train_data = make_dataset(config, train=True)
    val_data = make_dataset(config, train=False) if config.validation else None
    result = model.fit(train_data, epochs=config.epochs, callbacks=callbacks,
                       validation_data=val_data)
    if config.validation and val_data is not None:
        # Reference averages the eval score across workers via
        # hvd.allreduce (:344-353); ours comes back already summed over
        # the ranks.
        logger.info("final validation: %s", model.evaluate(val_data))
    logger.info("throughput: %.1f images/sec", result.images_per_sec)


if __name__ == "__main__":
    main()

"""Three API front-ends over one engine: the port of the JAX package's
``frontends/``.

The reference reaches one capability through three frameworks
(tf.estimator / Keras / PyTorch); here three API *styles* wrap the
single engine in ``training/loop.py``:

* :mod:`estimator` — ``Estimator(model_fn).train(input_fn, ...)``
* :mod:`keras_style` — ``Model.compile(...).fit(..., callbacks=[...])``
* :mod:`explicit` — the hand-written-loop style: you own the loop, we
  provide the built pieces.

Where the JAX front-ends take a ``mesh``, these take the ``device``
(``None`` means CUDA, and raises without it) and the ``torch.distributed``
process group (``None``: the world when one is initialised).
"""

from distributeddeeplearning_tpu_torch.frontends import explicit
from distributeddeeplearning_tpu_torch.frontends.estimator import Estimator, RunConfig
from distributeddeeplearning_tpu_torch.frontends.keras_style import Model

__all__ = ["Estimator", "RunConfig", "Model", "explicit"]

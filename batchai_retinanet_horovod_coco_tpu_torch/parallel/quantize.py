"""Deprecated: the stateless quantized pmean, as the JAX package's
``parallel/quantize.py``.  ``comm/compress.py`` subsumes it (bucketed,
with error feedback in ``TrainState.comm_state``); ``quantized_pmean``
stays as a thin alias, which ``--quantized-allreduce`` maps onto
``--comm-compress int8``."""

from __future__ import annotations

from batchai_retinanet_horovod_coco_tpu_torch.comm.compress import bucketed_pmean


def quantized_pmean(grads, axis):
    """Deprecated: the stateless bucketed int8 pmean (no error feedback) of
    ``{path: gradient}`` over ``axis`` (``parallel/mesh.py::DataAxis``):
    one symmetric rounding of the already reduced gradient, at most
    max|block| / 254 an element."""
    return bucketed_pmean(grads, axis)

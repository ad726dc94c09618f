"""Distribution layer: data-parallel lifetime training over the ranks of a
device mesh (counterpart of plastic_unet_tpu.parallel).

Only the sample stream is parallel. The model is a CNN of about five million
parameters with no attention and no sequence axis, so tensor, pipeline or
sequence parallelism would buy nothing; the one sequential axis, the
lifetime hebb recurrence, is handled by the trace-coherence modes of
parallel.dp. One process per device (torchrun), NCCL on CUDA, Gloo on the
CPU (parallel.mesh).
"""

from plastic_unet_tpu_torch.parallel.dp import (  # noqa: F401
    dp_state_sharding,
    make_dp_epoch_fn,
    make_dp_multi_epoch_fn,
    shard_stream,
)
from plastic_unet_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    DCN_AXIS,
    init_distributed,
    make_mesh,
    make_multislice_mesh,
)
from plastic_unet_tpu_torch.parallel.multihost import process_local_slice, stage_global_stream  # noqa: F401

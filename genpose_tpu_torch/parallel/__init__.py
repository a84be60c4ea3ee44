"""Data parallelism over several devices, one process per device
(counterpart of ``genpose_tpu/parallel/``)."""

from genpose_tpu_torch.parallel.group import (  # noqa: F401
    DPGroup,
    active,
    all_gather_rows,
    launch,
    local_draw,
    make_group,
    pad_to_multiple,
    replicate,
    shard_batch,
    sharded,
)

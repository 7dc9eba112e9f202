"""Device mesh and multi-process runs (counterpart of
``mile_tpu.parallel``)."""
from mile_tpu_torch.parallel.mesh import (  # noqa: F401
    ChainMesh,
    chain_data_mesh,
    chain_mesh,
    local_devices,
    padded_chain_count,
    pick_chain_device_count,
)

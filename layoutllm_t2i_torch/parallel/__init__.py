"""Multi-device generation over torch.distributed (layoutllm_t2i_tpu/
parallel/): the group (mesh.py), its collectives (collectives.py) and the
tensor-parallel latency mode (tp.py)."""
from .mesh import Mesh, make_mesh, replicate, shard_batch  # noqa: F401

# importing the package registers the dataset catalog (reference
# GLIGEN/dataset/catalog.py role), as layoutllm_t2i_tpu/data/__init__.py does
from . import catalog as _catalog  # noqa: F401

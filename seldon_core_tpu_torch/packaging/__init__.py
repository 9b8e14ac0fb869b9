"""Container packaging of the port: wrap user model code into an image on
the port's engine image (``wrap.py``), as the reference's s2i python
wrapper (`wrappers/s2i/python/s2i/bin/assemble` + `run`) does."""

from seldon_core_tpu_torch.packaging.wrap import (  # noqa: F401
    containerfile_for_model,
    detect_runtime,
    wrap_model,
)

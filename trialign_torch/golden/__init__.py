from trialign_torch.golden.numpy_model import (  # noqa: F401
    align_bruteforce,
    align_planes_numpy,
    traceback_from_cuboid,
    rescore_alignment,
)

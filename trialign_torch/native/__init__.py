from trialign_torch.native.build import (  # noqa: F401
    align_native,
    build,
    is_available,
    score_native,
    score_native_batch,
)

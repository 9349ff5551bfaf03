from trialign_torch.io.datasets import (  # noqa: F401
    load_alt_triplet,
    load_dat_sequence,
    load_reference_triplet,
    read_fasta,
)

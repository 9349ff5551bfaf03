"""The port's kernels: each module holds a CUDA kernel's wrapper beside its
plain torch version (``ref`` is the plain whole-plane sweep itself)."""

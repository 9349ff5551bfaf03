"""The int32 rate probe (K6), the denominator of ``benchmarks.roofline``.

Port of the micro-kernel of ``trialign/benchmarks.py:measure_vpu_rate``:
eight independent int32 chains a lane, seeded from the input (x + r for
chain r), ``iters`` rounds of ``ops_per_iter`` element operations, then the
max of the chains.  Two op mixes, as ``csrc/vpu.cu`` describes them: the
reference's max/add pairs (``dpx=False``) and the same count of element
operations as Hopper ``__viaddmax_s32`` instructions, max(a + step, c)
(``dpx=True``).

On a CUDA tensor :func:`vpu_chains` launches ``csrc/vpu.cu``; on a CPU
tensor it runs :func:`vpu_ref`, the plain torch version, which gives the
same output tensor for the same inputs.
"""

from __future__ import annotations

import torch

from trialign_torch import _build

# ops_per_iter the kernel is built for.
OPS = (64, 512)
# The DPX mode's add: negative, so the chains stay bounded.
DPX_STEP = -1


def _check(x: torch.Tensor, iters: int, ops_per_iter: int) -> None:
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous() or \
            x.numel() < 1:
        raise ValueError("x must be a non-empty contiguous int32 vector")
    if ops_per_iter not in OPS or iters < 0:
        raise ValueError(f"ops_per_iter must be one of {OPS} and iters >= 0")


def vpu_ref(x: torch.Tensor, iters: int, ops_per_iter: int = 512,
            dpx: bool = False, step: int = DPX_STEP) -> torch.Tensor:
    """Plain torch version of K6: the max of each lane's eight chains after
    ``iters`` rounds, an int32 tensor shaped as ``x``.  Adds wrap at 32
    bits, as the kernel's."""
    acc = [x + r for r in range(8)]
    for _ in range(iters):
        for r in range(ops_per_iter // 2):
            j = r % 4
            if dpx:
                h = (r // 4) % 2
                acc[2 * j + h] = torch.maximum(acc[2 * j + 1 - h] + step,
                                               acc[2 * j + h])
            else:
                acc[2 * j] = torch.maximum(acc[2 * j], acc[2 * j + 1])
                acc[2 * j + 1] = acc[2 * j + 1] + acc[2 * j]
    return torch.stack(acc).amax(dim=0)


def vpu_chains(x: torch.Tensor, iters: int, ops_per_iter: int = 512,
               dpx: bool = False, step: int = DPX_STEP) -> torch.Tensor:
    """K6 over every element of ``x`` (one thread each): on a CPU tensor
    :func:`vpu_ref`; on a CUDA tensor the kernel, which never falls back.
    Nothing waits for the card."""
    _check(x, iters, ops_per_iter)
    if x.device.type == "cpu":
        return vpu_ref(x, iters, ops_per_iter, dpx, step)
    if x.device.type != "cuda":
        raise ValueError(f"no vpu kernel for device {x.device}")
    lib = _build.load("vpu")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.trialign_vpu(
            x.data_ptr(), x.numel(), iters, ops_per_iter, int(dpx), step,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "vpu kernel launch")
    vpu_chains.launches += 1
    return out


# Launches of the CUDA kernel since the count was last set to 0.
vpu_chains.launches = 0


def full_card_lanes(device="cuda") -> int:
    """Threads that fill every SM of the card at once at K6's launch shape."""
    lib = _build.load("vpu")
    sms = torch.cuda.get_device_properties(
        torch.device(device)).multi_processor_count
    return sms * lib.trialign_vpu_blocks_per_sm() * lib.trialign_vpu_threads()

"""Batched RSC max-log-MAP and turbo decodes on the CUDA kernel.

`rsc_maxlogmap_batch_kernel` launches `turbo_rsc_map` in
`csrc/turbo_rsc.cu`, which replaces both TPU kernels of
`convolutionalencdec_tpu/kernels/turbo_pallas.py` (the forward at
pallas_call :283 and the backward at :300) and the `_beta_tail` recurrence
beside them, in one launch: alpha and beta walk from both ends at once,
meet in the middle, and each emits the other half's LLRs while a helper
warp replays the other recursion a round ahead.  Its plain version
`rsc_maxlogmap_batch_plain` is the scan `ops.turbo.rsc_maxlogmap`; the
kernel equals it on every entry (its renormalisation cancels in the LLRs:
csrc/turbo_rsc.cu).  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.  `LAUNCHES` counts the launches.

The turbo decoders run the exchange of `ops.turbo` (`turbo_iteration`:
3/4 extrinsic scaling with floor division, the a-priori clamp, the
interleave and de-interleave as gathers; torch operations between the two
MAP launches) over the kernel.  `turbo_decode_batch_kernel_early` stops
once every block's CRC passes: after each iteration the host reads
`ok.all()`, one synchronisation per iteration, as the JAX `while_loop`
tests its condition on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.turbo import (RscSpec, _fields, decode_early, decode_fixed,
                         rsc_maxlogmap, rsc_tables)
from .acs import _check_device

#: Launches of the kernel since the count was last set to 0.
LAUNCHES = {"turbo_rsc_map": 0}


def turbo_kernel_supported(rsc: RscSpec) -> bool:
    """The kernel keeps a block's states in adjacent lanes of one warp:
    2 <= NS <= 8, the JAX kernel's gate."""
    return 2 <= rsc.num_states <= 8


@functools.lru_cache(maxsize=None)
def _edge_table(rsc: RscSpec, device: torch.device) -> torch.Tensor:
    """int32 [10, NS] on `device`: per state, its two predecessors, their
    inputs and parities, its two successors and their parities (the
    kernel's `tab`)."""
    nxt, par, prev, pu = rsc_tables(rsc)
    states = np.arange(rsc.num_states)
    zp = par[pu, prev]                      # parity of edge e into d
    tab = np.stack([prev[0], prev[1], pu[0], pu[1], zp[0], zp[1],
                    nxt[0], nxt[1], par[0, states], par[1, states]])
    return torch.as_tensor(tab.astype(np.int32), device=device)


def rsc_maxlogmap_batch_plain(rsc: RscSpec, l_sys, l_par, l_apriori,
                              l_sys_tail, l_par_tail) -> torch.Tensor:
    """Plain version of `rsc_maxlogmap_batch_kernel`: the scan
    `ops.turbo.rsc_maxlogmap`."""
    return rsc_maxlogmap(rsc, l_sys, l_par, l_apriori, l_sys_tail,
                         l_par_tail)


def rsc_maxlogmap_batch_kernel(rsc: RscSpec, l_sys, l_par, l_apriori,
                               l_sys_tail, l_par_tail,
                               device=None) -> torch.Tensor:
    """Batched a-posteriori LLRs of RSC blocks.

    Replaces `rsc_maxlogmap_batch_kernel` of
    convolutionalencdec_tpu/kernels/turbo_pallas.py (pallas_calls :283 and
    :300).

    Args: int32 [B, L] l_sys, l_par, l_apriori and [B, S] l_sys_tail,
    l_par_tail (positive favours 0).  Returns int32 [B, L], equal to
    `ops.turbo.rsc_maxlogmap` under the exchange's contract (|l_apriori|
    <= LA_CLAMP, channel LLRs far below it).
    """
    if not turbo_kernel_supported(rsc):
        raise ValueError("turbo kernels support NS <= 8 (one group of "
                         "lanes per block); use ops.turbo.rsc_maxlogmap")
    l_sys, l_par, l_apriori, l_sys_tail, l_par_tail = _fields(
        device, l_sys, l_par, l_apriori, l_sys_tail, l_par_tail)
    B, L = l_sys.shape
    S = rsc.S
    if (l_par.shape != (B, L) or l_apriori.shape != (B, L)
            or l_sys_tail.shape != (B, S) or l_par_tail.shape != (B, S)):
        raise ValueError(f"fields must be [B, L] = [{B}, {L}] and tails "
                         f"[B, S] = [{B}, {S}]")
    if not _check_device(l_sys):
        return rsc_maxlogmap_batch_plain(rsc, l_sys, l_par, l_apriori,
                                         l_sys_tail, l_par_tail)
    dev = l_sys.device
    out = torch.empty((B, L), dtype=torch.int32, device=dev)
    if B == 0 or L == 0:
        return out
    NS = rsc.num_states
    inputs = [x.contiguous() for x in (l_sys, l_par, l_apriori, l_sys_tail,
                                       l_par_tail)]
    from . import _build
    lib = _build.library()
    # The half-walks' checkpoints, one a 32-step chunk (csrc/turbo_rsc.cu).
    scratch = torch.empty(lib.turbo_rsc_map_scratch_words(B, L, NS),
                          dtype=torch.int32, device=dev)
    code = lib.turbo_rsc_map(
        *(x.data_ptr() for x in inputs), _edge_table(rsc, dev).data_ptr(),
        scratch.data_ptr(), out.data_ptr(), B, L, NS, S,
        torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["turbo_rsc_map"] += 1
    _build.check("turbo_rsc_map", code)
    return out


def turbo_decode_batch_kernel(rsc: RscSpec, l_sys, l_par1, l_par2,
                              l_sys_tail1, l_par_tail1, l_sys_tail2,
                              l_par_tail2, perm, n_iters: int = 6,
                              device=None):
    """Batched turbo decode over the kernel, equal to
    `ops.turbo.turbo_decode_batch` (the same exchange).

    Replaces `turbo_decode_batch_kernel` of
    convolutionalencdec_tpu/kernels/turbo_pallas.py.  Args: [B, L] channel
    LLR fields, [B, S] tails, `perm` the interleaver [L].  Returns (uint8
    [B, L] bits, int32 [B, L] a-posteriori LLRs).
    """
    return decode_fixed(rsc_maxlogmap_batch_kernel, rsc,
                        (l_sys, l_par1, l_par2, l_sys_tail1, l_par_tail1,
                         l_sys_tail2, l_par_tail2), perm, n_iters, device)


def turbo_decode_batch_kernel_early(rsc: RscSpec, l_sys, l_par1, l_par2,
                                    l_sys_tail1, l_par_tail1, l_sys_tail2,
                                    l_par_tail2, perm, crc=None,
                                    max_iters: int = 8, device=None):
    """Turbo decode over the kernel with CRC-gated early termination.

    Replaces `turbo_decode_batch_kernel_early` of
    convolutionalencdec_tpu/kernels/turbo_pallas.py.  After every full
    iteration the batch's CRCs are checked (`ops.crc`); blocks latch their
    first CRC-passing bits and LLRs, and the loop stops once every block
    has passed or at `max_iters`.  `crc` is the `CrcSpec` the blocks carry
    (e.g. CRC24B per 36.212 code block).

    Returns (bits uint8 [B, L], lapp int32 [B, L], ok bool [B], iterations
    used, an int).
    """
    if crc is None:
        raise ValueError("early termination needs a CrcSpec (pass "
                         "crc=CRC24B or use turbo_decode_batch_kernel)")
    return decode_early(rsc_maxlogmap_batch_kernel, rsc,
                        (l_sys, l_par1, l_par2, l_sys_tail1, l_par_tail1,
                         l_sys_tail2, l_par_tail2), perm, crc, max_iters,
                        device)

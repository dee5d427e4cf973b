"""Convolutional encoder on tensors.

Port of `convolutionalencdec_tpu/ops/encode.py`.  The whole packet is
encoded at once: each coded output stream j is the mod-2 convolution of the
input bit stream with generator j, computed as an XOR of strided slices,
one slice per set generator tap.  It is parallel over time and batch, so
plain tensor code is right for it; there is no kernel to write.

Semantics:
  * bits shift into the LSb of the tapped delay;
  * generators are bit-reversed so the LSb taps the newest bit;
  * the output segment packs generator j's bit at bit position j;
  * termination appends S all-zero input steps and returns the register to
    state 0;
  * bytes are consumed MSb-first.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor
from ..params import CodeSpec
from .bits import unpack_bits


def _state_prefix_bits(spec: CodeSpec, state: torch.Tensor) -> torch.Tensor:
    """Virtual input history implied by a starting state, oldest first: bit
    m of the delay register is the input from m shifts ago."""
    w = spec.k * spec.S
    idx = torch.arange(w - 1, -1, -1, dtype=torch.int32, device=state.device)
    return ((state[..., None] >> idx) & 1).to(torch.uint8)


def encode_bits(spec: CodeSpec, bits: torch.Tensor, terminate: bool = True,
                initial_state: torch.Tensor | None = None, device=None):
    """Encode 0/1 bits into n-bit coded segments.

    Args:
      spec: the code.
      bits: 0/1 uint8 tensor [..., L]; L must be a multiple of k.
      terminate: if True, append S all-zero steps to force the encoder back
        to state 0.
      initial_state: optional int32 tensor [...] of starting states (default
        spec.starting_state), for chunked use.
      device: where a non-tensor `bits` goes (default the CUDA card); a
        tensor keeps its own device.

    Returns:
      (segments uint8 [..., T], final_state int32 [...]) with
      T = L/k + S if terminated, else L/k.  final_state is 0 after
      termination.
    """
    bits = as_tensor(bits, torch.uint8, device)
    L = bits.shape[-1]
    if L % spec.k != 0:
        raise ValueError(f"bit count {L} not a multiple of k={spec.k}")
    kS = spec.k * spec.S
    lead = bits.shape[:-1]
    if initial_state is None:
        initial_state = torch.full(lead, spec.starting_state,
                                   dtype=torch.int32, device=bits.device)
    initial_state = torch.as_tensor(initial_state, dtype=torch.int32,
                                    device=bits.device).expand(lead)
    parts = [_state_prefix_bits(spec, initial_state), bits]
    if terminate:
        parts.append(torch.zeros(lead + (kS,), dtype=torch.uint8,
                                 device=bits.device))
    full = torch.cat(parts, dim=-1)

    T = L // spec.k + (spec.S if terminate else 0)
    segment = torch.zeros(lead + (T,), dtype=torch.uint8, device=bits.device)
    # For output step r the newest bit sits at full[kS + (r+1)*k - 1]; tap m
    # of the reversed generator reads m positions earlier.
    for j, grev in enumerate(spec.g_reversed):
        out_j = torch.zeros_like(segment)
        for m in range(spec.delay_width):
            if (grev >> m) & 1:
                start = kS + spec.k - 1 - m
                out_j ^= full[..., start:start + (T - 1) * spec.k + 1:spec.k]
        segment |= out_j << j

    # Final state: the last k*S bits of the stream, newest at bit 0.
    tail = full[..., full.shape[-1] - kS:].to(torch.int32)
    weights = 1 << torch.arange(kS - 1, -1, -1, dtype=torch.int32,
                                device=bits.device)
    final_state = (tail * weights).sum(dim=-1, dtype=torch.int32)
    return segment, final_state


def encode_bytes(spec: CodeSpec, data, terminate: bool = True,
                 device=None) -> torch.Tensor:
    """Encode uint8 bytes [..., N] (MSb-first per byte) into coded segments
    uint8 [..., T], terminated unless `terminate` is False; `device` as in
    `encode_bits`."""
    segments, _ = encode_bits(spec, unpack_bits(data, device=device),
                              terminate)
    return segments


def encode_one_input(spec: CodeSpec, state: int, u: int) -> tuple[int, int]:
    """One trellis step on host ints: shift the k bits of `u` in and return
    (coded segment, next state)."""
    delay = ((state << spec.k) | u) & ((1 << spec.delay_width) - 1)
    seg = 0
    for j, grev in enumerate(spec.g_reversed):
        seg |= (bin(delay & grev).count("1") & 1) << j
    return seg, delay & (spec.num_states - 1)


def encode_bits_np(spec: CodeSpec, bits: np.ndarray, terminate: bool = True,
                   initial_state: int = 0) -> np.ndarray:
    """Scalar numpy oracle encoder of one packet: a naive shift-register
    walk, an independent check of `encode_bits`.  Returns uint8 [T]."""
    bits = np.asarray(bits, dtype=np.uint8).ravel()
    if bits.size % spec.k != 0:
        raise ValueError("bit count not a multiple of k")
    if terminate:
        bits = np.concatenate([bits, np.zeros(spec.k * spec.S, np.uint8)])
    delay = int(initial_state)
    segs = []
    for r in range(bits.size // spec.k):
        for b in bits[r * spec.k:(r + 1) * spec.k]:
            delay = ((delay << 1) | int(b)) & ((1 << spec.delay_width) - 1)
        seg = 0
        for j, grev in enumerate(spec.g_reversed):
            seg |= (bin(delay & grev).count("1") & 1) << j
        segs.append(seg)
    return np.array(segs, dtype=np.uint8)

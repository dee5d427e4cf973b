"""Telemetry: throughput metering, run configuration, the traffic model.

Port of `convolutionalencdec_tpu/utils/telemetry.py`.  The reference
codebase prints the code parameters at startup (berTestK7.c:56-64) and a
Mbps line about once a second (speedEncode.c:25-35, 84-103): `describe`
renders a CodeSpec the same way and `ThroughputMeter` keeps the
steady-state rate.  `kernel_traffic` is the analytic device-memory traffic
of one decode call in the port's layout: the two-pass routes write int32
decision words [B, T, ceil(NS/32)] and read them back; the single-pass
kernel (csrc/block_1p.cu) keeps them in shared memory.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..params import CodeSpec

#: The modes of `kernel_traffic`, in the order `traffic_report` prints.
MODES = ("block", "block_int32", "block_soft", "ragged", "stream")


def describe(spec: CodeSpec) -> str:
    """Human-readable code parameter block (cf. berTestK7.c:56-64)."""
    g_oct = ", ".join(f"0o{gi:o}" for gi in spec.g)
    lines = [
        f"Convolutional code: K={spec.K}, k={spec.k}, n={spec.n}, "
        f"Rc={spec.k}/{spec.n}",
        f"  generators (Proakis MSB-first): [{g_oct}]",
        f"  states: {spec.num_states}, traceback_len: {spec.traceback_len}",
        f"  butterfly/poly-symmetry eligible: {spec.has_poly_symmetry}",
    ]
    return "\n".join(lines)


@dataclass
class ThroughputMeter:
    """Steady-state throughput meter (cf. speedEncode.c:64-103).

    Usage:
        meter = ThroughputMeter()
        while ...:
            out = step(...)
            torch.cuda.synchronize()   # count only finished work
            line = meter.tick(bits_processed)
            if line: print(line)
    """
    report_every_s: float = 1.0
    _t0: float = field(default=0.0, init=False)
    _bits: int = field(default=0, init=False)
    _total_bits: int = field(default=0, init=False)
    _start: float = field(default=0.0, init=False)

    def __post_init__(self):
        self._t0 = self._start = time.perf_counter()

    def tick(self, bits: int) -> str | None:
        """Account `bits`; returns a rate line once per report interval."""
        self._bits += bits
        self._total_bits += bits
        now = time.perf_counter()
        dt = now - self._t0
        if dt >= self.report_every_s:
            rate = self._bits / dt / 1e6
            self._t0 = now
            self._bits = 0
            return f"{rate:.2f} Mbit/s"
        return None

    @property
    def average_mbps(self) -> float:
        dt = time.perf_counter() - self._start
        return self._total_bits / dt / 1e6 if dt > 0 else 0.0


def kernel_traffic(spec: CodeSpec, batch: int, steps: int,
                   mode: str = "block") -> dict:
    """Analytic device-memory traffic of one decode call, in bytes and
    bytes per decoded bit, in the port's layout (each input read once,
    each output written once; shared-memory traffic excluded).  The
    output is the byte decode's: ceil(L / 8) bytes per channel,
    L = (steps - S) * k.

    Modes (the JAX package's names, the port's routes):

    - "block": the two-pass hard route (`select_kernel` BUTTERFLY): the
      forward reads the uint8 segments and writes int32 decision words
      [B, T, ceil(NS/32)] and the int32 final metrics [B, NS]; the walk
      reads the words and writes the output.
    - "block_int32": the route of codes the JAX package's SWAR kernels do
      not take.  Where `use_single_pass(spec, steps)` holds it is the
      single-pass kernel (SINGLE_PASS): segments in, output out, no
      decisions; else it is "block".
    - "block_soft": the two-pass soft route: int8 LLRs [B, T, n] in,
      otherwise "block".
    - "ragged": "block" with int32 lengths [B] read by the walk (full
      lengths: the walk reads every step's words).
    - "stream": the register-exchange stream kernel: segments in, one
      symbol byte per step out, and per channel the carried state (int32
      metric and int64 survivor register per state) read and written.
    """
    from ..kernels.single_pass import use_single_pass
    NS, n = spec.num_states, spec.n
    B, T = batch, steps
    decoded_bits = (T - spec.S) * B * spec.k
    dec_bytes = B * T * (-(-NS // 32)) * 4
    out_bytes = B * (-(-(T - spec.S) * spec.k // 8))
    fm = B * NS * 4
    if mode == "block_int32" and use_single_pass(spec, T):
        fwd_r, fwd_w, tb_r, tb_w = B * T, 0, 0, out_bytes
    elif mode in ("block", "block_int32"):
        fwd_r, fwd_w, tb_r, tb_w = B * T, dec_bytes + fm, dec_bytes, out_bytes
    elif mode == "block_soft":
        fwd_r, fwd_w = B * T * n, dec_bytes + fm
        tb_r, tb_w = dec_bytes, out_bytes
    elif mode == "ragged":
        fwd_r, fwd_w = B * T, dec_bytes + fm
        tb_r, tb_w = dec_bytes + 4 * B, out_bytes
    elif mode == "stream":
        state = 12 * NS * B
        fwd_r, fwd_w, tb_r, tb_w = B * T + state, B * T + state, 0, 0
    else:
        raise ValueError(f"unknown mode {mode!r}")
    total = fwd_r + fwd_w + tb_r + tb_w
    return {
        "mode": mode,
        "forward_read_bytes": fwd_r,
        "forward_write_bytes": fwd_w,
        "traceback_read_bytes": tb_r,
        "traceback_write_bytes": tb_w,
        "glue_bytes": 0,
        "total_bytes": total,
        "bytes_per_decoded_bit": total / decoded_bits,
        "decoded_bits": decoded_bits,
    }


def traffic_report(spec: CodeSpec, batch: int, steps: int) -> str:
    """Render the per-kernel traffic table for all decode modes."""
    rows = [kernel_traffic(spec, batch, steps, m) for m in MODES]
    out = [f"Device-memory traffic per call (B={batch}, T={steps}, "
           f"K={spec.K}, NS={spec.num_states}):",
           f"  {'mode':11s} {'fwd R':>10s} {'fwd W':>10s} {'tb R':>10s} "
           f"{'tb W':>10s} {'glue':>10s} {'total':>11s} {'B/bit':>7s}"]
    for r in rows:
        out.append(
            f"  {r['mode']:11s} {r['forward_read_bytes']:>10,} "
            f"{r['forward_write_bytes']:>10,} {r['traceback_read_bytes']:>10,} "
            f"{r['traceback_write_bytes']:>10,} {r['glue_bytes']:>10,} "
            f"{r['total_bytes']:>11,} "
            f"{r['bytes_per_decoded_bit']:>7.2f}")
    return "\n".join(out)

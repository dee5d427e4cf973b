"""The port's harnesses and telemetry on the CPU.

`harness.bounds` is deterministic and held equal to the JAX package's,
float for float.  The measuring harnesses draw from a torch generator, not
`jax.random`, so they are held statistically: against the JAX harness's
own measurement at the same size, against the analytic bounds, and by the
orderings their quantities must keep.  `kernel_traffic` is held to hand
counts of the port's layout.
"""

import pytest
import torch

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu import harness as ref_harness
from convolutionalencdec_tpu.utils import telemetry as ref_telemetry

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch import harness, kernels, utils
from convolutionalencdec_tpu_torch.harness import speed
from convolutionalencdec_tpu_torch.kernels import single_pass

K7_R16 = dict(K=7, g=(0o133, 0o171, 0o165, 0o117, 0o127, 0o155))
K3_K2 = dict(K=3, k=2, g=(0o17, 0o06, 0o13))
BOUND_CODES = {"NASA_K7": (None, 24), "TOY_K3": (None, 24),
               "K5_23_35": (None, 24), "K7_R16": (K7_R16, 40),
               "K3_k2": (K3_K2, 24)}


def _specs(name):
    code = BOUND_CODES[name][0]
    if code is None:
        return getattr(ref, name), port.PRESETS[name]
    return ref.CodeSpec(**code), port.CodeSpec(**code)


@pytest.mark.parametrize("name", list(BOUND_CODES))
def test_bounds_equal_reference(name):
    ref_spec, spec = _specs(name)
    dmax = BOUND_CODES[name][1]
    d_ref, a_ref, c_ref = ref_harness.distance_spectrum(ref_spec, dmax)
    d, a, c = harness.distance_spectrum(spec, dmax)
    assert d == d_ref
    assert a.tolist() == a_ref.tolist() and c.tolist() == c_ref.tolist()
    points = [-1.0, 0.0, 1.5, 3.0, 6.0, 10.0]
    for decision in ("hard", "soft"):
        for e in points:
            assert harness.union_bound_ber(spec, e, decision, dmax) == \
                ref_harness.union_bound_ber(ref_spec, e, decision, dmax)
    assert harness.bound_curve(spec, points, dmax) == \
        ref_harness.bound_curve(ref_spec, points, dmax)
    with pytest.raises(ValueError, match="decision"):
        harness.union_bound_ber(spec, 1.0, "list", dmax)


def test_bound_spectrum_of_the_rate_one_sixth_code():
    """d_free 30 with c_30 = 4: the default dmax of 24 bounds nothing."""
    _, spec = _specs("K7_R16")
    dfree, _, c = harness.distance_spectrum(spec, 40)
    assert dfree == 30 and c[30] == 4
    with pytest.raises(ValueError, match="dmax"):
        harness.distance_spectrum(spec)


def test_ber_point_matches_reference_harness():
    """berTestK7's -5 dB point at 512 packets of 256 bits: the port's
    measurement against the JAX harness's (different generators) and the
    channel's flip rate against the requested one."""
    p = harness.BER_EXPECTED_K7[0][1]
    got = harness.ber_point(port.NASA_K7, p, n_packets=512, packet_bits=256,
                            batch=256, device="cpu")
    want = ref_harness.ber_point(ref.NASA_K7, p, n_packets=512,
                                 packet_bits=256, batch=512)
    assert got.bits_tested == want.bits_tested == 512 * 256
    # ~500 bit errors in ~100 bursts on each side: within 4 sigma.
    assert 0.6 < got.measured_coded_ber / want.measured_coded_ber < 1.6
    assert got.measured_uncoded_ber == pytest.approx(p, rel=0.05)
    assert got.errors == round(got.measured_coded_ber * got.bits_tested)
    assert got.relative_error is None and got.passed is None


def test_reference_ber_test_structure():
    """Three points with their expectations; a decoder that returns all
    ones fails every gate."""
    results = harness.run_reference_ber_test(
        port.NASA_K7, n_packets=8, packet_bits=64, batch=8, verbose=False,
        decoder=lambda s: torch.ones((s.shape[0], 64), dtype=torch.uint8),
        device="cpu")
    assert [r.snr_db for r in results] == [-5.0, -4.0, -3.0]
    assert [r.expected_coded_ber for r in results] == \
        [e for _, _, e in ref_harness.BER_EXPECTED_K7]
    assert all(0.3 < r.measured_coded_ber < 0.7 and r.passed is False
               for r in results)
    assert harness.BER_EXPECTED_K7 == ref_harness.BER_EXPECTED_K7
    assert harness.ber.ALLOWED_RELATIVE_ERROR == \
        ref_harness.ber.ALLOWED_RELATIVE_ERROR
    sweep = harness.ber_sweep(port.NASA_K7, [-5.0, 0.0], n_packets=16,
                              packet_bits=64, device="cpu")
    assert sweep[0].uncoded_ber == port.uncoded_ber_bpsk(-5.0)
    assert sweep[1].measured_coded_ber <= sweep[0].measured_coded_ber


def test_run_curve_on_the_single_pass_route():
    """The rate-1/6 code's curve: both decodes on the SINGLE_PASS route
    (plain versions here); hard within a factor of two of its union bound
    at 0 dB, soft below hard, both falling with Eb/N0."""
    _, spec = _specs("K7_R16")
    T = 128 + spec.S
    assert kernels.select_kernel(spec, T=T) == kernels.SINGLE_PASS
    assert kernels.select_kernel(spec, "soft", T=T) == kernels.SINGLE_PASS
    pts = harness.run_curve(spec, [0.0, 2.0], n_packets=32, packet_bits=128,
                            batch=16, device="cpu", verbose=False)
    assert [p["ebn0_db"] for p in pts] == [0.0, 2.0]
    assert all(p["bits"] == 32 * 128 for p in pts)
    bound = harness.union_bound_ber(spec, 0.0, "hard", 40)
    assert 0.5 < pts[0]["hard_ber"] / bound < 2.0
    for p in pts:
        assert p["soft_ber"] < p["hard_ber"]
    assert pts[1]["hard_ber"] < pts[0]["hard_ber"]
    assert pts[1]["soft_ber"] < pts[0]["soft_ber"]


def test_tbcc_bler_curve_orderings():
    """The CRC-list decode never loses a block the wrap decode got and
    only counts false accepts among its wrong blocks."""
    pts = harness.run_bler_curve_tbcc(ebn0_points=[0.0, 2.0], n_packets=64,
                                      payload_bits=40, batch=32,
                                      device="cpu", verbose=False)
    for p in pts:
        assert p["blocks"] == 64
        assert p["false_accept"] <= p["crc_list_bler"] <= p["plain_bler"]
    assert pts[1]["plain_bler"] < pts[0]["plain_bler"]


def test_turbo_harnesses_small():
    pts = harness.run_bler_curve_turbo([0.0, 3.0], L=40, n_blocks=8,
                                       batch=4, n_iters=2, device="cpu",
                                       verbose=False)
    assert [p["blocks"] for p in pts] == [8, 8]
    assert pts[1]["ber"] <= pts[0]["ber"] and pts[1]["bler"] <= pts[0]["bler"]
    harq = harness.run_harq_ir_turbo(L=40, n_blocks=8, batch=8, n_iters=2,
                                     device="cpu", verbose=False)
    assert [h["tx_count"] for h in harq] == [1, 2, 3, 4]
    assert harq[-1]["rv"] == [0, 2, 3, 1]
    # Four transmissions' accumulated redundancy does no worse than one.
    assert harq[-1]["ir_bler"] <= harq[0]["ir_bler"]
    assert harness.TURBO_EXPECTED == ref_harness.TURBO_EXPECTED


def test_speed_benches_need_the_card():
    for bench in (speed.bench_encode, speed.bench_decode,
                  speed.bench_decode_ragged):
        with pytest.raises(RuntimeError, match="CUDA card"):
            bench(device="cpu")


def test_describe_and_meter():
    for name in ("NASA_K7", "TOY_K3"):
        assert utils.describe(port.PRESETS[name]) == \
            ref_telemetry.describe(getattr(ref, name))
    meter = utils.ThroughputMeter(report_every_s=0.0)
    line = meter.tick(10 ** 6)
    assert line is not None and line.endswith("Mbit/s")
    assert meter.tick(0) is not None
    assert meter.average_mbps > 0
    slow = utils.ThroughputMeter(report_every_s=3600.0)
    assert slow.tick(5) is None


def _hand(spec, B, T):
    """Hand counts: segments B T, LLRs B T n, int32 words B T ceil(NS/32)
    4, final metrics B NS 4, output bytes B ceil((T - S) k / 8)."""
    words = B * T * -(-spec.num_states // 32) * 4
    fm = B * spec.num_states * 4
    out = B * -(-(T - spec.S) * spec.k // 8)
    two_pass = (B * T, words + fm, words, out)
    return {
        "block": two_pass,
        "block_int32": ((B * T, 0, 0, out) if
                        single_pass.use_single_pass(spec, T) else two_pass),
        "block_soft": (B * T * spec.n, words + fm, words, out),
        "ragged": (B * T, words + fm, words + 4 * B, out),
        "stream": (B * T + 12 * spec.num_states * B,
                   B * T + 12 * spec.num_states * B, 0, 0),
    }


@pytest.mark.parametrize("name", ["NASA_K7", "K7_R16"])
def test_kernel_traffic_hand_counts(name):
    _, spec = _specs(name) if name == "K7_R16" else (None, port.NASA_K7)
    for B, T in ((2048, 2054), (3, 5000)):
        hand = _hand(spec, B, T)
        for mode, (fr, fw, tr, tw) in hand.items():
            r = utils.kernel_traffic(spec, B, T, mode)
            assert (r["forward_read_bytes"], r["forward_write_bytes"],
                    r["traceback_read_bytes"],
                    r["traceback_write_bytes"]) == (fr, fw, tr, tw), mode
            assert r["glue_bytes"] == 0 and r["mode"] == mode
            assert r["total_bytes"] == fr + fw + tr + tw
            assert r["decoded_bits"] == (T - spec.S) * B
            assert r["bytes_per_decoded_bit"] == \
                r["total_bytes"] / r["decoded_bits"]
    # At the main path's size the single pass moves 17.3 / 1.13 = 15x fewer
    # bytes than the two-pass route; past 32 KiB a channel it is two-pass.
    short = utils.kernel_traffic(spec, 2048, 2054, "block_int32")
    assert short["forward_write_bytes"] == 0
    assert utils.kernel_traffic(spec, 3, 5000, "block_int32") == \
        dict(utils.kernel_traffic(spec, 3, 5000, "block"),
             mode="block_int32")
    report = utils.traffic_report(spec, 2048, 2054)
    assert [line.split()[0] for line in report.splitlines()[2:]] == \
        list(utils.telemetry.MODES)
    with pytest.raises(ValueError, match="mode"):
        utils.kernel_traffic(spec, 1, 10, "swar")


def test_kernel_traffic_counts_k():
    spec = port.CodeSpec(**K3_K2)
    r = utils.kernel_traffic(spec, 256, 256, "block")
    assert r["decoded_bits"] == (256 - spec.S) * 256 * 2
    assert r["traceback_write_bytes"] == 256 * -(-(256 - spec.S) * 2 // 8)

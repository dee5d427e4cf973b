#!/usr/bin/env python3
"""Rule 2's ranking of the port's kernels from one `chip_smoke.py` run.

    python3 scripts/torch_kernel_ranking.py SMOKE.log

Reads the `{"kernels": [...]}` line of a `chip_smoke.py` output and prints,
as a markdown table, each kernel row's launches on the main paths times
(its time - its bound), counting only the launches made at the size at
which the row was timed: a row's `launches_by_path` says which path made
each launch, and RULES below names the paths timed at each size.  The
launches at other sizes (the harness paths, the streaming chunks where no
time at their size exists, the tail-biting extensions) are listed as left
out.  The generic-k rows count each main-path code at its own time and
bound (`by_code`).  Rows of kernels already redesigned are marked (since
the wide template of K13 and the one-word ragged walk were, every row).
"""

from __future__ import annotations

import json
import sys

# row -> [(size, paths timed at that size, ms field, bound field)].
RULES = {
    "acs_k1_forward": [("(a)", ("hard", "hard ragged"), "ms", "bound_ms")],
    "traceback_k1": [("(a)", ("hard", "soft", "punctured soft"), "ms",
                      "bound_ms")],
    "acs_soft_k1_forward": [("(a)", ("soft", "soft ragged", "punctured soft"),
                             "ms", "bound_ms"),
                            ("(f)", ("tailbiting crc soft",
                                     "tailbiting rate-matched"), "f_ms",
                             "f_bound_ms")],
    "traceback_k1_ragged": [("(a)", ("soft ragged", "hard ragged"), "ms",
                             "bound_ms")],
    # The streaming packets: 8 calls of 256 steps and one of 6 a packet,
    # hard and soft, each at its own time at 256 steps.
    "stream_k1_decode": [("256 steps", ("stream hard",), "ms_256_steps",
                          "bound_ms_256_steps"),
                         ("256 steps soft", ("stream soft",),
                          "soft_ms_256_steps", "bound_ms_256_steps")],
    "traceback_k1_masked": [
        ("288 steps", ("block stream hard", "block stream soft"), "ms",
         "bound_ms"),
        ("(f)", ("tailbiting crc soft", "tailbiting rate-matched"),
         "tailbiting_ms", "tailbiting_bound_ms")],
    "traceback_k1_multi": [("(f)", ("tailbiting crc soft",
                                    "tailbiting rate-matched"), "ms",
                            "bound_ms")],
    "maxlogmap_k1": [("(h)", ("maxlogmap",), "ms", "bound_ms")],
    "turbo_rsc_map": [("(i)", ("turbo serving", "turbo fixed"), "ms",
                       "bound_ms")],
    "acs_small_forward": [("(k)", ("small hard", "small ragged"), "ms",
                           "bound_ms")],
    "acs_soft_small_forward": [("(k)", ("small soft",), "ms", "bound_ms")],
    "traceback_k1 w1": [("(k)", ("small hard", "small soft"), "ms",
                         "bound_ms")],
    "traceback_k1_ragged w1": [("(k)", ("small ragged",), "ms", "bound_ms")],
    "block_decode_1p": [
        ("(m)", ("single pass hard", "single pass bits"), "ms", "bound_ms"),
        ("(m) soft", ("single pass soft",), "soft_ms", "soft_bound_ms")],
    "block_decode_1p wide": [
        ("(o)", ("(o) hard",), "ms", "bound_ms"),
        ("(o) soft", ("(o) soft",), "soft_ms", "soft_bound_ms")],
}
WIDE = ("acs_wide_forward", "acs_soft_wide_forward", "traceback_wide",
        "traceback_wide_ragged", "traceback_wide_masked",
        "traceback_wide_multi")
GENERIC = ("acs_generic_forward", "traceback_generic",
           "acs_generic_k2_forward", "traceback_generic_k2")
# Redesigned after their port (rule 2): not taken again.
REDESIGNED = {"acs_wide_forward", "acs_soft_wide_forward",
              "acs_generic_forward", "acs_generic_k2_forward",
              "turbo_rsc_map", "traceback_generic", "traceback_generic_k2",
              "traceback_wide", "traceback_wide_masked",
              "traceback_wide_ragged", "traceback_wide_multi",
              "block_decode_1p", "traceback_k1", "traceback_k1_masked",
              "acs_soft_k1_forward", "traceback_k1_ragged", "maxlogmap_k1",
              "traceback_k1 w1", "acs_small_forward",
              "acs_soft_small_forward", "stream_k1_decode",
              "acs_k1_forward", "traceback_k1_multi",
              "traceback_k1_ragged w1", "block_decode_1p wide"}


def terms(row):
    """[(size, launches, ms, bound ms)] of the launches the row counts, and
    the launches it leaves out."""
    by_path = row.get("launches_by_path", {})
    name = row["name"]
    out = []
    if name in GENERIC:
        for code, t in row["by_code"].items():
            n = sum(by_path.get(f"generic {code} {kind}", 0)
                    for kind in ("bytes", "bits"))
            if n:
                out.append((code, n, t["ms"], t["bound_ms"]))
    elif name in WIDE:
        out.append(("(l)", row["launches"], row["ms"], row["bound_ms"]))
    else:
        for size, paths, ms_key, bound_key in RULES[name]:
            n = sum(by_path.get(p, 0) for p in paths)
            if name == "stream_k1_decode":
                n -= 1  # each packet's last call: 6 steps
            if n:
                out.append((size, n, row[ms_key], row[bound_key]))
    counted = sum(t[1] for t in out)
    return out, row["launches"] - counted


def main() -> int:
    line = next(x for x in open(sys.argv[1]) if x.startswith('{"kernels"'))
    rows = json.loads(line)["kernels"]
    ranked = []
    for row in rows:
        parts, left_out = terms(row)
        gap = sum(n * (ms - bound) for _, n, ms, bound in parts)
        ranked.append((gap, row["name"], parts, left_out))
    ranked.sort(reverse=True)
    print("| kernel | size: launches × (ms − bound ms) | left out | "
          "launches × gap (ms) |")
    print("|---|---|---|---|")
    for gap, name, parts, left_out in ranked:
        mark = " (redesigned)" if name in REDESIGNED else ""
        terms_text = "; ".join(f"{size}: {n} × ({ms:.4f} − {bound:.4f})"
                               for size, n, ms, bound in parts) or "—"
        print(f"| `{name}`{mark} | {terms_text} | {left_out} | {gap:.2f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())

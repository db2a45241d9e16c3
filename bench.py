#!/usr/bin/env python
"""Benchmark entry: runs `pwn_vocoder.benchmarks.run_bench` on the local GPU.

Prints, on stderr, the full detail; on stdout, the card's name and power
limit (nvidia-smi) and then, as the LAST line, one JSON object:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
     "device": {"platform": ..., "kind": ..., "count": N}}

metric: student IAF synthesis throughput in audio-seconds generated per
wall-second per device (== x realtime); vs_baseline is the ratio against
the north-star target of 100x realtime.

Exits non-zero, printing no result line, when JAX finds no GPU or the GPU
has no entry in the peak table (`benchmarks.PEAKS`).

    python bench.py
"""

import json
import subprocess
import sys


def card_line() -> str:
    """`name, power.limit` of GPU 0 as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    import jax

    from pwn_vocoder.benchmarks import device_info, peak_for, run_bench
    from pwn_vocoder.utils.compile_cache import enable_compile_cache

    info = device_info()
    if info["platform"] != "gpu":
        print(f"bench.py needs a GPU; JAX found {jax.devices()}",
              file=sys.stderr)
        return 1
    try:
        peak_for(info["kind"])
    except KeyError as e:
        print(f"bench.py: {e}", file=sys.stderr)
        return 1
    enable_compile_cache()
    print(f"card: {card_line()}", flush=True)
    result = run_bench("student_iaf")
    print("detail: " + json.dumps(result["detail"], default=str),
          file=sys.stderr, flush=True)
    line = {k: result[k] for k in ("metric", "value", "unit",
                                   "vs_baseline")}
    line["device"] = info
    if "error" in result:
        line["error"] = result["error"]
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Device time of the port's tensor-core flash kernel beside PyTorch's
``scaled_dot_product_attention`` at the long LM prefill's attention, in a
process that profiles nothing else first.

    python3 attention_yardstick.py [--seed 0] [--calls 8]

granite-3-2b's attention at one sequence of 32,768 tokens: q (1, 32,
32768, 64) over k and v of 8 KV heads, bf16, causal, as transposed
views of (B, S, H, D) tensors (the model's layout), random from
``--seed``.  The library call gets its KV heads expanded outside the
timing.  ``repro_torch.bench.device_time.device_ms`` times each in turns
(kernel, library, library, kernel), ``--calls`` calls a window; each
window says whether it kept every record (a window late in a process
that profiled many times loses records of long launches, which is why
this is its own process and not a phase of ``chip_smoke.py``).  The
library call is a yardstick only: the port never calls it.  Prints the
card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

#: granite-3-2b at the 1 x 32,768 prefill: 32 heads over 8 KV heads
SHAPE = dict(b=1, h=32, hk=8, s=32768, d=64)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_yardstick: needs a CUDA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.bench.device_time import device_ms
    from repro_torch.kernels import ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    sh = SHAPE
    q, k, v = (torch.randn((sh["b"], sh["s"], hh, sh["d"]), generator=gen,
                           device="cuda", dtype=torch.bfloat16
                           ).transpose(1, 2)
               for hh in (sh["h"], sh["hk"], sh["hk"]))
    g = sh["h"] // sh["hk"]
    ke, ve = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    fns = {"kernel": lambda: ops.flash_attention(q, k, v),
           "library": lambda: torch.nn.functional.scaled_dot_product_attention(
               q, ke, ve, is_causal=True)}
    # heads 0-1 of the two outputs, a sanity check and not the kernel's
    # gate (chip_smoke.py holds it per element on the model's inputs)
    diff = float((fns["kernel"]()[:, :2].float()
                  - fns["library"]()[:, :2].float()).abs().max())
    ops.reset_launch_counts()
    out = {n: [] for n in fns}
    for n in ("kernel", "library", "library", "kernel"):
        d = device_ms(fns[n], calls=args.calls)
        out[n].append(dict(ms=d["ms"], complete=d["complete"]))
    launched = ops.launch_counts()["flash_attention"]
    if launched < 1:
        raise AssertionError("the tensor-core flash kernel never launched: "
                             f"{ops.launch_counts()}")
    print(json.dumps(dict(out, tensor_core_launches=launched,
                          max_abs_diff_heads_0_1=diff,
                          shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} "
                                "bf16 causal")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Card measurements of the sketch kernel (``csrc/sketch_conv.cu``) and
the CUDA-core flash kernel (``csrc/flash_attention.cu``,
``flash_attention_simt_kernel``) against earlier sources.

    PYTHONPATH=src python -m repro_torch.bench.sketch_flash \\
        [--sass LIBRARY.so ...] [--turns-sketch OLD.cu]
        [--turns-flash OLD.cu] [--out FILE]

* ``--sass``: the SASS of every sketch kernel in each library
  (``cuobjdump -sass``): the instructions a tap (a FFMA), by opcode, of
  the innermost loop holding the most FFMAs (the run-time walk, the
  first version's tap loop) or of the walk where it is straight-line
  code (:func:`tap_costs`); and whether any kernel of the library
  touches local memory.
* ``--turns-sketch OLD.cu``: builds ``OLD.cu`` (an earlier source with
  the same C interface and flags), holds it and the current library bit
  for bit to ``ref.sketch_conv_fma_ref`` at ssh-ecg's build chunk
  (4096 x 512) and query batch (192 x 512), W 80, step 3, the encoder's
  own filter, and times the two in turns (old, current, current, old):
  device time (``bench.device_time.device_ms``) and call time (CUDA
  events around back-to-back calls; the old library through a replica of
  its wrapper, the current one through ``kernels.sketch_conv``); beside
  them ``F.conv1d``'s device time.
* ``--turns-flash OLD.cu``: the same for the CUDA-core flash kernel at
  the float32 serve gate's shape, q (8, 32, 128, 64) with 8 KV heads,
  causal, (B, S, H, D) tensors as transposed views, held to the plain
  version within ``flash_attention.error_bound`` (the library call's
  time is ``chip_smoke.py``'s: the port itself never calls one).

Prints JSON lines; ``--out`` also writes them to a file.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from repro_torch.bench.collision_count import build, hot_loop
from repro_torch.bench.device_time import call_ms, device_ms
from repro_torch.bench.dtw_schedules import _opcode, sass_functions
from repro_torch.kernels import _build

_SKETCH = r"sketch_conv_kernel(?:ILi(\d+)ELi(\d+)E)?"
#: ssh-ecg's sketch shapes: a build chunk and a query batch (64 x 3 offsets)
SKETCH_ROWS = {"build": 4096, "query": 192}
FLASH_SHAPE = dict(b=8, h=32, hk=8, s=128, d=64)


def tap_costs(lib: str) -> dict:
    """Per sketch kernel of ``lib`` (``<W,step>``, or ``<runtime>``): the
    instructions a tap (a FFMA) of its FFMA loop, or, where the walk is
    unrolled into straight-line code (the written (W, step) pairs), of
    the walk: first FFMA to last, tap and x loads included (``scope``);
    with the opcodes counted;
    ``local_memory``: the kernels with LDL or STL."""
    out, local = {}, []
    for name, lines in sass_functions(lib).items():
        if any(_opcode(t) in ("LDL", "STL") for _, t in lines):
            local.append(name)
        m = re.search(_SKETCH, name)
        if not m:
            continue
        ops, scope = hot_loop(lines, "FFMA"), "loop"
        if not ops["FFMA"]:
            at = [k for k, (_, t) in enumerate(lines) if _opcode(t) == "FFMA"]
            ops = collections.Counter(_opcode(t) for _, t in
                                      lines[at[0]:at[-1] + 1]) \
                if at else collections.Counter()
            scope = "walk"
        n_ins = sum(ops.values())
        tag = (f"<{m.group(1)},{m.group(2)}>"
               if m.group(1) and m.group(1) != "0" else "<runtime>")
        out[tag] = dict(scope=scope, instructions=n_ins, ffma=ops["FFMA"],
                        per_tap=n_ins / ops["FFMA"] if ops["FFMA"] else None,
                        ops=dict(ops.most_common(8)))
    return dict(kernels=out, local_memory=local)


def ptxas_lines(tag: str) -> List[str]:
    log = (_build.BUILD_DIR / "bench" / f"{tag}.log").read_text()
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def _first_sketch(lib, x, filters, step):
    """The first sketch wrapper's host work and launch: its checks, a
    ctypes call for the shared-memory size, the launch."""
    if not (x.is_cuda and filters.device == x.device):
        raise ValueError("x and filters on one CUDA device")
    if x.dtype != torch.float32 or filters.dtype != torch.float32:
        raise TypeError("float32")
    b, m = x.shape
    w, f = filters.shape
    n_b = (m - w) // step + 1
    out = torch.empty((b, n_b, f), dtype=torch.float32, device=x.device)
    x, filters = x.contiguous(), filters.contiguous()
    if lib.sketch_conv_smem_bytes(w, f, step) > 227 * 1024:
        raise ValueError("shared memory")
    rc = lib.sketch_conv_launch(
        x.data_ptr(), filters.data_ptr(), out.data_ptr(), b, m, w, f, step,
        n_b, torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"old sketch launch failed: CUDA error {rc}")
    return out


def _first_simt(lib, q, k, v):
    """The first flash wrapper's host work for the CUDA-core kernel (its
    checks, two ctypes calls) and the launch; causal, default scale."""
    from repro_torch.kernels import flash_attention as fa
    fa._check(q, k, v)
    b, h, s, d = q.shape
    hk, t = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if d > lib.flash_attention_max_head_dim():
        raise ValueError("head dim")
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    rc = lib.flash_attention_simt_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        fa._DTYPES[q.dtype], b, h, hk, s, t, d, *strides, float(d ** -0.5),
        1, torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"old flash launch failed: CUDA error {rc}")
    return out


def in_turns(fns: Dict[str, object], rounds: int = 2) -> dict:
    """Device and call ms of each callable, in turns (a b, b a, ...)."""
    names = list(fns)
    dev = {n: [] for n in names}
    call = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            dev[n].append(device_ms(fns[n], calls=50)["ms"])
            call[n].append(call_ms(fns[n]))
    return dict(device_ms=dev, call_ms=call,
                mean_device_ms={n: float(np.mean(v)) for n, v in dev.items()},
                mean_call_ms={n: float(np.mean(v)) for n, v in call.items()})


def sketch_turns(old_src: str, seed: int = 0) -> dict:
    from repro_torch.configs import ssh_ecg
    from repro_torch.data.timeseries import (extract_subsequences,
                                             synthetic_ecg)
    from repro_torch.encoders import SSHEncoder
    from repro_torch.kernels import ref
    from repro_torch.kernels.sketch_conv import sketch_conv
    old = build(Path(old_src), "sketch_conv_old", "sketch_conv")
    dev = torch.device("cuda")
    step = ssh_ecg.CONFIG.params["step"]
    filt = SSHEncoder(ssh_ecg.CONFIG).materialize(dev)._require_state()[
        "filters"]
    n = max(SKETCH_ROWS.values())
    series = torch.as_tensor(extract_subsequences(
        synthetic_ecg(n * 64 + 512, seed=seed), 512, stride=64, max_count=n,
        znorm=True), device=dev)
    torch.backends.cudnn.allow_tf32 = False
    wconv = filt.t().contiguous()[:, None, :]
    out = {}
    for tag, rows in SKETCH_ROWS.items():
        x = series[:rows]
        emu = ref.sketch_conv_fma_ref(x, filt, step)
        plain = ref.sketch_conv_ref(x, filt, step)
        new, prev = sketch_conv(x, filt, step), _first_sketch(old, x, filt,
                                                              step)
        for name, got in (("current", new), ("old", prev)):
            if not torch.equal(got, emu):
                raise AssertionError(
                    f"sketch {name} kernel is not bit-identical to "
                    f"sketch_conv_fma_ref at {tag}: "
                    f"{int((got != emu).sum())} outputs differ")
        times = in_turns({
            "old": lambda x=x: _first_sketch(old, x, filt, step),
            "current": lambda x=x: sketch_conv(x, filt, step)})
        conv = (lambda x=x: torch.nn.functional.conv1d(
            x[:, None, :], wconv, stride=step))
        out[tag] = dict(
            times, shape=f"x {tuple(x.shape)} filters {tuple(filt.shape)} "
                         f"step {step}",
            sign_flips={name: int(((got >= 0) != (plain >= 0)).sum())
                        for name, got in (("current", new), ("old", prev))},
            library_device_ms=device_ms(conv, calls=50)["ms"],
            library_call_ms=call_ms(conv))
    out["ptxas_old"] = ptxas_lines("sketch_conv_old")
    out["sass_old"] = tap_costs(str(_build.BUILD_DIR / "bench" /
                                    "sketch_conv_old.so"))
    return out


def flash_turns(old_src: str, seed: int = 0) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (error_bound,
                                                     flash_attention_simt)
    old = build(Path(old_src), "flash_attention_old", "flash_attention")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sh = FLASH_SHAPE
    q, k, v = (torch.randn((sh["b"], sh["s"], hh, sh["d"]), generator=gen,
                           device="cuda").transpose(1, 2)
               for hh in (sh["h"], sh["hk"], sh["hk"]))
    plain = ref.flash_attention_ref(q, k, v, causal=True)
    for name, got in (("current", flash_attention_simt(q, k, v)),
                      ("old", _first_simt(old, q, k, v))):
        err = (got - plain).abs()
        if not bool((err <= error_bound(got, plain, v)).all()):
            raise AssertionError(f"flash {name} beyond error_bound: "
                                 f"{float(err.max())}")
    times = in_turns({"old": lambda: _first_simt(old, q, k, v),
                      "current": lambda: flash_attention_simt(q, k, v)})
    return dict(times, shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} "
                             f"float32 causal, transposed views",
                ptxas_old=ptxas_lines("flash_attention_old"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", nargs="*", default=[])
    ap.add_argument("--turns-sketch", metavar="OLD.cu")
    ap.add_argument("--turns-flash", metavar="OLD.cu")
    ap.add_argument("--out")
    args = ap.parse_args()
    results = {}
    for lib in args.sass:
        results[f"sass {lib}"] = tap_costs(lib)
    if args.turns_sketch or args.turns_flash:
        if not torch.cuda.is_available():
            raise SystemExit("the turns time kernels: they need a CUDA GPU")
        results["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        if args.turns_sketch:
            results["sketch_turns"] = sketch_turns(args.turns_sketch)
        if args.turns_flash:
            results["flash_turns"] = flash_turns(args.turns_flash)
    text = "\n".join(json.dumps({k: v}) for k, v in results.items())
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

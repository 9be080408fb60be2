"""Card measurements of the collision-count kernels
(``csrc/collision_count.cu``).

    PYTHONPATH=src python -m repro_torch.bench.collision_count \\
        [--sass LIBRARY.so ...] [--turns OLD.cu] [--out FILE]

* ``--sass``: the SASS of the batch kernel in each library (``cuobjdump
  -sass``): the instructions of its hot loop (the innermost backward
  loop holding the most integer compares) by opcode, and from them the
  instructions a key compared (:func:`key_costs`); and whether any
  kernel of the library touches local memory (``LDL``/``STL``).
* ``--turns OLD.cu``: builds ``OLD.cu`` (an earlier version of the
  source, same C interface, same flags), checks it and the current
  library against the plain version, and times the two in turns (old,
  current, current, old) by CUDA events at the serving shapes: queries
  (192, 40) against (2^20, 40) for the batch kernel, one query (40,)
  against it for the single-query kernel, and the single-query kernel
  on a view with a misaligned base (``db[5:]`` at K = 33); and reads the
  SM clock and power while the batch kernel runs (:func:`clock_under`).

Prints JSON lines; ``--out`` also writes them to a file.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import time
from pathlib import Path
from typing import Dict, List

import torch

from repro_torch.bench.dtw_schedules import _opcode, sass_functions
from repro_torch.kernels import _build
from repro_torch.kernels.collision_count import NAME

_TARGET = r"\bBRA\b.*?(0x[0-9a-f]+)"
_BATCH = r"collision_count_batch_kernelILi(\d+)E"
SERVING = dict(b=192, n=1 << 20, k=40)       # 64 queries x 3 offsets
BATCH_R = 2              # database rows a thread of the batch kernel holds


def hot_loop(ins: List[tuple], opcode: str = "ISETP"
             ) -> collections.Counter:
    """Opcodes of the innermost backward-branch loop (one that holds no
    other) with the most ``opcode``s: for the batch kernel, ISETP, the
    walk over query rows, its key loop unrolled."""
    loops = []
    for k, (addr, text) in enumerate(ins):
        tgt = re.search(_TARGET, text)
        if _opcode(text) == "BRA" and tgt and int(tgt.group(1), 16) <= addr:
            start = int(tgt.group(1), 16)
            loops.append((start, addr, collections.Counter(
                _opcode(t) for a, t in ins[:k + 1] if a >= start)))
    inner = [(s, e, c) for s, e, c in loops
             if not any(e2 != e and s <= s2 and e2 <= e
                        for s2, e2, _ in loops)]
    if not inner:
        return collections.Counter()
    return max(inner, key=lambda x: x[2][opcode])[2]


def key_costs(lib: str) -> dict:
    """Per batch-kernel instance ``<KP>`` of ``lib``: the hot loop's
    instructions and opcodes, the keys it compares (``BATCH_R`` rows x
    KP slots x the query rows nvcc unrolled, read off the ISETP count,
    which also holds the loop's own test) and the instructions a key
    compared; ``local_memory``: the kernels with LDL or STL."""
    out, local = {}, []
    for name, lines in sass_functions(lib).items():
        if any(_opcode(t) in ("LDL", "STL") for _, t in lines):
            local.append(name)
        m = re.search(_BATCH, name)
        if not m:
            continue
        loop = hot_loop(lines)
        per_row = BATCH_R * int(m.group(1))
        keys = per_row * (loop["ISETP"] // per_row)
        n_ins = sum(loop.values())
        out[f"batch<{m.group(1)}>"] = dict(
            instructions=n_ins, compares=keys,
            per_key=n_ins / keys if keys else None,
            lds_per_key=loop["LDS"] / keys if keys else None,
            ops=dict(loop.most_common()))
    return dict(batch=out, local_memory=local)


def build(src: Path, tag: str, name: str = NAME) -> ctypes.CDLL:
    """``src`` compiled with the kernel libraries' flags into
    ``build/repro_torch/bench/<tag>.so``; loaded with the C signatures of
    library ``name``.  ptxas's report is kept beside it."""
    out = _build.BUILD_DIR / "bench" / f"{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src} ({tag}):\n{res.stdout}"
                           f"{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _build.SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _batch(lib, q, db):
    out = torch.empty((q.shape[0], db.shape[0]), dtype=torch.int32,
                      device=db.device)
    rc = lib.collision_count_batch_launch(
        q.data_ptr(), db.data_ptr(), out.data_ptr(), q.shape[0],
        db.shape[0], db.shape[1], torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"batch launch failed: CUDA error {rc}")
    return out


def _one(lib, q, db):
    out = torch.empty((db.shape[0],), dtype=torch.int32, device=db.device)
    rc = lib.collision_count_launch(
        q.data_ptr(), db.data_ptr(), out.data_ptr(), db.shape[0],
        db.shape[1], torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"single-query launch failed: CUDA error {rc}")
    return out


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(True), torch.cuda.Event(True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def in_turns(fns: Dict[str, object], iters: int, rounds: int = 2
             ) -> Dict[str, List[float]]:
    """ms of each callable, timed in turns (a b c, c b a, ...)."""
    names = list(fns)
    out = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            out[n].append(_time_ms(fns[n], iters))
    return out


def clock_under(fn, iters: int) -> str:
    """``nvidia-smi``'s SM clock and power draw, read while a queue of
    ``iters`` calls of ``fn`` runs on the card."""
    fn()
    torch.cuda.synchronize()
    for _ in range(iters):
        fn()
    time.sleep(0.3)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.cuda.synchronize()
    return smi


def turns(old_src: str, seed: int = 0) -> dict:
    """The earlier source and the current library, checked and timed in
    turns."""
    from repro_torch.kernels import ref
    libs = {"old": build(Path(old_src), "collision_count_old"),
            "current": _build.load(NAME)}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, n, k = SERVING["b"], SERVING["n"], SERVING["k"]
    db = torch.randint(0, 4, (n, k), generator=gen, device="cuda",
                       dtype=torch.int32)
    q = torch.randint(0, 4, (b, k), generator=gen, device="cuda",
                      dtype=torch.int32)
    db33 = torch.randint(0, 4, (n + 5, 33), generator=gen, device="cuda",
                         dtype=torch.int32)[5:]
    want_b = ref.collision_count_batch_ref(q, db)
    shapes = {"batch": (_batch, q, db, want_b),
              "one": (_one, q[0], db, ref.collision_count_ref(q[0], db)),
              "one_misaligned_k33": (_one, q[0, :33], db33,
                                     ref.collision_count_ref(q[0, :33],
                                                             db33))}
    out = {}
    for shape, (fn, qq, dd, want) in shapes.items():
        for name, lib in libs.items():
            if not torch.equal(fn(lib, qq, dd), want):
                raise AssertionError(f"{name} disagrees with the plain "
                                     f"version at {shape}")
        iters = 20 if shape == "batch" else 200
        ms = in_turns({name: (lambda lib=lib: fn(lib, qq, dd))
                       for name, lib in libs.items()}, iters)
        out[shape] = dict(ms=ms, mean_ms={m: sum(v) / len(v)
                                          for m, v in ms.items()},
                          shape=f"query {tuple(qq.shape)} db "
                                f"{tuple(dd.shape)}")
    out["clock_under_batch"] = clock_under(
        lambda: _batch(libs["current"], q, db), 1500)
    out["ptxas_old"] = [
        ln.strip() for ln in (_build.BUILD_DIR / "bench" /
                              "collision_count_old.log").read_text()
        .splitlines() if "registers" in ln or "spill" in ln]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", nargs="*", default=[])
    ap.add_argument("--turns", metavar="OLD.cu")
    ap.add_argument("--out")
    args = ap.parse_args()
    results = {}
    for lib in args.sass:
        results[f"sass {lib}"] = key_costs(lib)
    if args.turns:
        if not torch.cuda.is_available():
            raise SystemExit("--turns times the kernels: it needs a CUDA "
                             "GPU")
        results["card"] = torch.cuda.get_device_name(0)
        results["turns"] = turns(args.turns)
    text = "\n".join(json.dumps({k: v}) for k, v in results.items())
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Card measurements of the DTW kernels' two schedules
(``csrc/dtw_wavefront.cu``).

    PYTHONPATH=src python -m repro_torch.bench.dtw_schedules \\
        [--sass LIBRARY.so ...] [--sweep] [--out FILE]

* ``--sass``: the SASS of every DTW kernel in each library (``cuobjdump
  -sass``): the instructions of the innermost loop that holds its cell
  arithmetic, by opcode, and from them the instructions a DP cell at
  r = 25 (:func:`cell_costs`).  Works on any build of the source,
  earlier ones included (the single warp-per-pair design,
  ``dtw_pairs_kernel`` / ``dtw_one_kernel``).
* ``--sweep``: both schedules of the single-query kernel timed by CUDA
  events at m = 512 over candidate counts from 32 to 2^18 at r = 6, 25
  and 63, no threshold, in turns; the crossover where rows become faster
  (:func:`crossover`); and the diagonal schedule's abandon test every k
  diagonals at the sequential re-rank's shape (303 candidates, one
  threshold, the 10th smallest cost).

Prints JSON lines; ``--out`` also writes them to a file.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

# patterns (re caches them): an instruction line, a branch target, a DTW
# kernel's mangled name with its template arguments
_INSTR = r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;"
_TARGET = r"\bBRA\b.*?(0x[0-9a-f]+)"
_KERNEL = (r"(dtw_rows_kernel|dtw_diag_kernel|dtw_pairs_kernel|"
           r"dtw_one_kernel)ILi(\d+)E(?:Lb([01])ELb([01])E)?")


def kernel_of(name: str):
    """(kind, n, thr, one) of a DTW kernel's mangled name, else None."""
    k = re.search(_KERNEL, name)
    return k.groups() if k else None


def _opcode(text: str) -> str:
    """'@!P0 FMNMX.FTZ R1, ...' -> 'FMNMX'."""
    words = text.split()
    if words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0]


def cuobjdump() -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise RuntimeError("cuobjdump not found on PATH or in "
                           "/usr/local/cuda/bin")
    return tool


def sass_functions(lib: str) -> Dict[str, List[tuple]]:
    """{mangled name: [(address, instruction text)]} of a library."""
    sass = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            funcs[cur] = []
        elif cur is not None:
            ins = re.search(_INSTR, line)
            if ins:
                funcs[cur].append((int(ins.group(1), 16), ins.group(2)))
    return funcs


def cell_loop(ins: List[tuple]) -> dict:
    """The innermost backward-branch loop holding the most FADDs: its
    instruction count and opcodes, and the sizes of every loop with as
    many FADDs (a runtime test nvcc unswitched gives two)."""
    loops = []
    for k, (addr, text) in enumerate(ins):
        tgt = re.search(_TARGET, text)
        if _opcode(text) == "BRA" and tgt and int(tgt.group(1), 16) <= addr:
            start = int(tgt.group(1), 16)
            body = [_opcode(t) for a, t in ins[:k + 1] if a >= start]
            loops.append(collections.Counter(body))
    if not loops:
        return dict(instructions=len(ins), sizes=[], loops=0)
    most = max(c["FADD"] for c in loops)
    best = sorted((c for c in loops if c["FADD"] == most),
                  key=lambda c: sum(c.values()))
    inner = best[0]
    return dict(instructions=sum(inner.values()), fadd=inner["FADD"],
                ops=dict(inner.most_common()), loops=len(loops),
                sizes=[sum(c.values()) for c in best])


def cell_costs(lib: str, r: int = 25) -> dict:
    """Instructions a DP cell at radius ``r``, per DTW kernel of ``lib``.

    * rows (``dtw_rows_kernel<W, thr, one>``): the row loop holds W slots
      of which 2r + 1 run; a slot's instructions are (loop<64> -
      loop<32>) / 32, the rest of the loop is the row's overhead, so a cell
      costs slot + overhead / (2r + 1) thread instructions.
    * diagonals (``dtw_diag_kernel<S, thr, one>``): the loop takes two
      diagonals, 2r + 1 cells, with every lane issuing: 32 x loop /
      (2r + 1) lane slots a cell.
    * the earlier warp kernels (``dtw_pairs_kernel<S>``,
      ``dtw_one_kernel<S>``): the loop takes one diagonal of r + 1/2
      cells on average: 32 x loop / (r + 1/2); the smallest such loop is
      the one without a threshold when nvcc unswitched the runtime test.
    """
    found = {}
    for name, lines in sass_functions(lib).items():
        k = kernel_of(name)
        if k:
            found[(k[0], int(k[1]), k[2], k[3])] = cell_loop(lines)
    out = {}
    for (kind, n, thr, one), loop in sorted(found.items()):
        key = f"{kind}<{n}{'' if thr is None else f',thr={thr},one={one}'}>"
        entry = dict(loop)
        if kind == "dtw_rows_kernel" and n == 64 and \
                (kind, 32, thr, one) in found:
            small = found[(kind, 32, thr, one)]["instructions"]
            slot = (loop["instructions"] - small) / 32
            overhead = small - 32 * slot
            entry.update(per_slot=slot, row_overhead=overhead,
                         per_cell=slot + overhead / (2 * r + 1))
        elif kind == "dtw_diag_kernel" and n == 1:
            entry.update(per_cell=32 * loop["instructions"] / (2 * r + 1))
        elif kind in ("dtw_pairs_kernel", "dtw_one_kernel") and \
                n == -(-(2 * r + 2) // 32):
            entry.update(per_cell=32 * min(loop["sizes"]) / (r + 0.5),
                         per_cell_with_thr=32 * max(loop["sizes"])
                         / (r + 0.5))
        out[key] = entry
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


def _walks(n: int, m: int, gen: torch.Generator) -> torch.Tensor:
    w = torch.randn((n, m), generator=gen, device="cuda").cumsum(1)
    return (w - w.mean(1, keepdim=True)) / w.std(1, keepdim=True)


def crossover(rows: List[dict]) -> int:
    """The smallest count from which the row schedule is at least as fast
    as the diagonal one at every larger count of the sweep."""
    best = None
    for e in sorted(rows, key=lambda e: -e["n"]):
        if e["rows_ms"] > e["diagonals_ms"]:
            break
        best = e["n"]
    return best


def sweep(seed: int = 0) -> dict:
    from repro_torch.kernels import dtw_wavefront as kd
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    m = 512
    counts = [32, 512, 2048, 4096, 6144, 8192, 12288, 16384, 24576, 32768,
              65536, 1 << 18]
    x_all = _walks(counts[-1], m, gen)
    q = _walks(1, m, gen)[0]
    out = {"m": m, "by_radius": {}}
    for r in (6, 25, 63):
        lines = []
        for n in counts:
            x = x_all[:n]
            fns = {s: (lambda s=s: kd.dtw_wavefront(q, x, r, schedule=s))
                   for s in kd.SCHEDULES}
            if not torch.equal(fns["rows"](), fns["diagonals"]()):
                raise AssertionError(f"schedules disagree at n={n}, r={r}")
            iters = max(3, min(50, int(2e6 / (n * (2 * r + 1)))))
            ms = {s: [] for s in kd.SCHEDULES}
            for turn in range(2):       # rows, diagonals, diagonals, rows
                for s in (kd.SCHEDULES if turn == 0 else kd.SCHEDULES[::-1]):
                    ms[s].append(_time_ms(fns[s], iters))
            lines.append(dict(n=n, rows_ms=sum(ms["rows"]) / 2,
                              diagonals_ms=sum(ms["diagonals"]) / 2,
                              rule=kd.dtw_schedule(n, m, r)))
        c = crossover(lines)
        slots = -(-(r + 1) // 32)
        out["by_radius"][r] = dict(
            lines=lines, crossover=c,
            pairs_per_cell=None if c is None else c * slots / (2 * r + 1))
    # the diagonal schedule's abandon test every k diagonals, at the
    # sequential re-rank's shape
    x = x_all[:303]
    exact = ref.dtw_wavefront_ref(q, x, 25)
    thr = exact.sort().values[9]
    keep = kd.DIAG_CHECK_EVERY
    checks = {}
    try:
        for k in (2, 4, 8, 16, 32, 64):
            kd.DIAG_CHECK_EVERY = k
            fn = (lambda: kd.dtw_wavefront(q, x, 25, thr,
                                           schedule="diagonals"))
            if not torch.equal(fn(), ref.dtw_wavefront_ref(q, x, 25, thr)):
                raise AssertionError(f"check_every {k}: not bit-identical")
            checks[k] = _time_ms(fn, 50)
    finally:
        kd.DIAG_CHECK_EVERY = keep
    out["diag_check_every_ms"] = checks
    out["diag_check_abandoned"] = int((exact > thr).sum())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", nargs="*", default=[])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    results = {}
    for lib in args.sass:
        results[f"sass {lib}"] = cell_costs(lib)
    if args.sweep:
        if not torch.cuda.is_available():
            raise SystemExit("the sweep times the kernels: it needs a CUDA "
                             "GPU")
        results["card"] = torch.cuda.get_device_name(0)
        results["sweep"] = sweep()
    text = "\n".join(json.dumps({k: v}) for k, v in results.items())
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

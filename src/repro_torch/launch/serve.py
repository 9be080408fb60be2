"""LM serving launcher (counterpart of the LM half of
``repro.launch.serve``): step the KV-cache decode over a batch of
prompts, generate greedily, and run one prefill of the same prompts.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b

Weights are random from ``--seed`` (no checkpoint is read).  Without
``--device cpu`` it runs on CUDA and raises where there is none.  The
SSH arches are not served here yet (ROADMAP.md §1, item 3: serving).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.bench.timing import StageTimer
from repro_torch.configs import granite_3_2b
from repro_torch.kernels import ops
from repro_torch.models import transformer as T

LM_ARCHS = {"granite-3-2b": granite_3_2b}


@dataclasses.dataclass
class ServeResult:
    """What one :func:`serve_lm` call produced and how long it took
    (host clock, synchronised at the end of each stage)."""
    generated: torch.Tensor       # (B, gen_len) greedy tokens
    prompt_logits: torch.Tensor   # (B, 1, V) decode logits after the prompt
    prefill_logits: torch.Tensor  # (B, 1, V) prefill of the same prompts
    prompt_s: float               # stepping decode_step over the prompts
    generate_s: float             # the gen_len greedy steps
    prefill_s: float

    @property
    def decode_ms_per_step(self) -> float:
        """Mean ms per generating decode step."""
        return self.generate_s * 1e3 / max(1, self.generated.shape[1])

    @property
    def generated_tokens_per_s(self) -> float:
        return self.generated.numel() / max(self.generate_s, 1e-12)


def check_prefill_against_decode(res: ServeResult, rel_tol: float) -> dict:
    """Hold the prefill's last-position logits (the flash path's causal
    mask) to the decode logits after the last prompt token
    (``decode_attention``'s ``kv_valid`` mask).

    Raises unless max |prefill - decode| <= ``rel_tol`` x max |prefill|,
    and unless the argmax is equal in every row whose top-2 margin
    exceeds that tolerance (elsewhere the two paths' rounding may
    legitimately swap the top two).  Returns the measured numbers.
    """
    pre = res.prefill_logits.float()
    dec = res.prompt_logits.float()
    scale = float(pre.abs().max())
    diff = float((pre - dec).abs().max())
    top2 = pre.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > rel_tol * scale
    same = pre.argmax(dim=-1) == dec.argmax(dim=-1)
    out = dict(max_abs_diff=diff, max_abs_logit=scale,
               rel_diff=diff / max(scale, 1e-30), rel_tol=rel_tol,
               rows=int(decided.numel()), rows_decided=int(decided.sum()),
               argmax_equal=int(same.sum()))
    if diff > rel_tol * scale:
        raise RuntimeError(f"prefill and stepped decode disagree: {out}")
    if bool((decided & ~same).any()):
        raise RuntimeError(f"prefill and stepped decode pick another token "
                           f"where the margin exceeds the tolerance: {out}")
    return out


def serve_lm(cfg: T.LMConfig, params: Optional[T.Params] = None,
             prompts: Optional[np.ndarray] = None, *, batch: int = 2,
             prompt_len: int = 16, gen_len: int = 8, seed: int = 0,
             device=None) -> ServeResult:
    """The reference's ``serve_lm`` loop (``launch/serve.py:147-170``):
    step ``decode_step`` over the prompts, then ``gen_len`` greedy steps
    (argmax, first index on ties); then one ``prefill`` of the prompts.

    ``params`` default to random ones from ``seed`` on ``device`` (CUDA
    unless the caller asks for the CPU); ``prompts`` (B, P) default to
    ``np.random.default_rng(seed).integers(0, vocab, (batch, prompt_len))``.
    """
    dev = ops.resolve_device(device)
    if params is None:
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
            seed), dev)
    if prompts is None:
        prompts = np.random.default_rng(seed).integers(
            0, cfg.vocab, (batch, prompt_len))
    toks = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=dev)
    b, p = toks.shape
    cache = T.init_cache(cfg, b, p + gen_len, dev)
    timer = StageTimer(device=dev)
    with timer.stage("prompt") as sync:
        for i in range(p):
            logits, cache = T.decode_step(params, cache, toks[:, i:i + 1],
                                          cfg)
        prompt_logits = sync(logits)
    with timer.stage("generate") as sync:
        out = []
        for _ in range(gen_len):
            nxt = logits[:, -1, :].argmax(dim=-1, keepdim=True)
            out.append(nxt)
            logits, cache = T.decode_step(params, cache, nxt, cfg)
        generated = sync(torch.cat(out, dim=1) if out else toks[:, :0])
    with timer.stage("prefill") as sync:
        prefill_logits = sync(T.prefill(params, toks, cfg))
    return ServeResult(generated=generated, prompt_logits=prompt_logits,
                       prefill_logits=prefill_logits,
                       prompt_s=timer.timings["prompt"],
                       generate_s=timer.timings["generate"],
                       prefill_s=timer.timings["prefill"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's SMOKE config instead of full width")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.arch.startswith("ssh"):
        raise NotImplementedError(
            f"--arch {args.arch}: SSH serving is not ported to repro_torch "
            "yet (ROADMAP.md §1, item 3: serving)")
    if args.arch not in LM_ARCHS:
        ap.error(f"--arch {args.arch}: the port serves {sorted(LM_ARCHS)}")
    mod = LM_ARCHS[args.arch]
    cfg = mod.SMOKE if args.smoke else mod.CONFIG
    dev = ops.resolve_device(args.device)
    res = serve_lm(cfg, batch=args.batch, prompt_len=args.prompt_len,
                   gen_len=args.gen_len, seed=args.seed, device=dev)
    diff = (res.prefill_logits.float() - res.prompt_logits.float()).abs()
    print(f"{cfg.name}{' (smoke)' if args.smoke else ''} on {dev}: "
          f"{args.batch} prompts of {args.prompt_len} tokens, "
          f"{args.gen_len} generated")
    print(f"decode: prompt {res.prompt_s:.3f} s; {res.decode_ms_per_step:.2f}"
          f" ms per generating step, {res.generated_tokens_per_s:.1f} "
          f"generated tok/s")
    print(f"prefill of the same prompts {res.prefill_s:.3f} s; max |prefill "
          f"- decode| of the last-position logits {float(diff.max()):.3g}")
    print(f"sample: {res.generated[0].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Train BST on synthetic behaviour sequences with the PyTorch/CUDA port,
then index the users' embedding trajectories with SSH for similar-user
retrieval: the paper's technique applied to a recommendation model.

    PYTHONPATH=src python examples/torch_train_recsys_ssh.py \\
        [--steps 5] [--users 512] [--device cpu]

Each user's history, looked up in the trained item table and averaged
over the embedding width, is a time series; a user's own trajectory must
be its top-1.  Runs on CUDA unless ``--device cpu``.
"""
import argparse

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.index import SSHParams
from repro_torch.data.recsys_data import seq_batch
from repro_torch.db import SearchConfig, TimeSeriesDB
from repro_torch.kernels import ops
from repro_torch.launch import steps


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--users", type=int, default=512)
    ap.add_argument("--user", type=int, default=7, help="the user to query")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Returns the train losses, the query user and its top-k users."""
    dev = ops.resolve_device(args.device)
    arch = get_arch("bst")
    cfg = arch.smoke_config
    params = steps.init_fn(arch, "train_batch", smoke=True, device=dev)()
    opt = steps.make_optimizer("recsys")
    opt_state = opt.init(params)
    train = steps.make_step(arch, "train_batch", "train", smoke=True)

    losses = []
    for step_i in range(args.steps):
        raw = seq_batch(args.batch, cfg.seq_len, vocab=cfg.vocab,
                        seed=step_i)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        params, opt_state, metrics = train(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        print(f"step {step_i}: bce={losses[-1]:.4f}")

    # SSH over user-history embedding trajectories: each user's history,
    # projected through the trained item table, is a time series
    raw = seq_batch(args.users, cfg.seq_len, vocab=cfg.vocab, seed=99)
    hist = torch.from_numpy(raw["history"] % cfg.vocab).to(dev, torch.int64)
    with torch.no_grad():
        traj = params["items"][hist].mean(-1)          # (users, seq_len)
        traj = (traj - traj.mean(1, keepdim=True)) / (
            traj.std(1, unbiased=False, keepdim=True) + 1e-6)
    spec = SSHParams(window=8, step=1, ngram=6, num_hashes=20,
                     num_tables=20).to_spec()
    # short trajectories: a tight band; top_c clamps to the users
    db = TimeSeriesDB.build(traj, spec=spec,
                            config=SearchConfig(topk=5, band=4), device=dev)
    res = db.search(traj[args.user])
    print(f"users most similar to user {args.user} (by behaviour "
          f"trajectory): {res.ids}")
    return {"losses": losses, "user": args.user, "ids": res.ids}


def main(argv=None) -> int:
    res = run(parse_args(argv))
    ok = int(res["ids"][0]) == res["user"]
    print("recsys + SSH retrieval OK" if ok else
          "recsys + SSH retrieval: the user is not its own top-1")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""The gnn and recsys families in the port's configs, steps and train
launcher, on the CPU: the registry against the reference's, every
recsys and gnn cell's input specs, ``launch.train.main`` with a
checkpoint and a resume bit-equal to the uninterrupted run, and a
checkpoint written by the reference restored bit for bit.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro.configs import bst as jbst
from repro.configs import get_arch as jget_arch
from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro_torch.configs import registry
from repro_torch.configs.base import TensorSpec
from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.launch import steps, train
from repro_torch.train.optimizer import tree_leaves

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = "cpu"
RECSYS = ["bst", "dien", "dlrm-rm2", "mind"]


def test_registry_covers_every_reference_arch():
    assert list_archs() == jregistry.list_archs()
    assert len(list_archs()) == 12
    assert list_archs("recsys") == RECSYS
    assert list_archs("gnn") == ["nequip"]
    for name in list_archs():
        assert get_arch(name).family == jget_arch(name).family


@pytest.mark.parametrize("arch", RECSYS + ["nequip"])
def test_input_specs_match_the_reference(arch):
    ours, theirs = get_arch(arch), jget_arch(arch)
    assert dataclasses.asdict(ours.config) == dataclasses.asdict(
        theirs.config)
    assert dataclasses.asdict(ours.smoke_config) == dataclasses.asdict(
        theirs.smoke_config)
    assert list(ours.shapes) == list(theirs.shapes)
    for shape, cell in theirs.shapes.items():
        assert ours.shapes[shape].kind == cell.kind
        assert ours.shapes[shape].meta == cell.meta
        assert dataclasses.asdict(ours.cell_config(shape)) == \
            dataclasses.asdict(theirs.cell_config(shape))
        kind, spec = ours.input_specs(shape)
        jkind, jspec = theirs.input_specs(shape)
        assert kind == jkind
        assert list(spec) == list(jspec)
        for k, s in jspec.items():
            assert isinstance(spec[k], TensorSpec)
            assert spec[k].shape == tuple(s.shape), (shape, k)
            assert str(spec[k].dtype)[6:] == str(s.dtype), (shape, k)


def test_gnn_specs_pad_to_4096():
    _, spec = get_arch("nequip").input_specs("minibatch_lg")
    assert spec["node_feat"].shape == (172032, 602)     # 169,984 padded
    assert spec["edge_src"].shape == (172032,)          # 168,960 padded
    _, spec = get_arch("nequip").input_specs("molecule")
    assert spec["graph_ids"].shape == (4096,)
    assert spec["energy"].shape == (128,)


@pytest.mark.parametrize("arch,shape,smoke", [
    ("dlrm-rm2", "train_batch", True), ("bst", "train_batch", True),
    ("dien", "train_batch", False), ("nequip", "molecule", False)])
def test_synthetic_batch_matches_reference(arch, shape, smoke):
    """The reference's draw, and its quirk: integers in [0, vocab) or
    [0, 100), so nequip's edges join its first 100 nodes."""
    want = jtrain.synthetic_batch(jget_arch(arch), shape, smoke, 2)
    got = train.synthetic_batch(get_arch(arch), shape, smoke, 2, CPU)
    assert list(got) == sorted(want)
    for k in want:
        assert str(got[k].dtype)[6:] == str(want[k].dtype)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if arch == "nequip":
        assert int(got["edge_src"].max()) < 100 <= got["positions"].shape[0]


def test_smoke_graph_batches_fit_the_smoke_config():
    arch = get_arch("nequip")
    mol = train.synthetic_batch(arch, "molecule", True, 1, CPU)
    assert mol["node_feat"].shape == (512, arch.smoke_config.d_feat)
    assert int(mol["graph_ids"].max()) == 127 and mol["energy"].shape == (128,)
    g = train.synthetic_batch(arch, "full_graph_sm", True, 1, CPU)
    assert set(g) == {"edge_dst", "edge_src", "node_feat", "node_targets",
                      "positions"}
    assert int(g["edge_src"].max()) < 64 and g["edge_src"].dtype == torch.int32


def test_steps_for_every_family_kind():
    for arch in RECSYS:
        a = get_arch(arch)
        for shape, cell in a.shapes.items():
            assert callable(steps.make_step(a, shape, cell.kind, smoke=True))
        with pytest.raises(ValueError, match="no step"):
            steps.make_step(a, "train_batch", "decode", smoke=True)
    a = get_arch("nequip")
    for shape in a.shapes:
        assert callable(steps.make_step(a, shape, "train", smoke=True))
    with pytest.raises(ValueError, match="no step"):
        steps.make_step(a, "molecule", "serve")
    params = steps.init_fn(a, "ogb_products", device=CPU)(
        torch.Generator().manual_seed(0))
    assert params["embed_w"].shape == (100, 32)          # the cell's d_feat
    assert params["layers"]["radial_w2"].shape == (5, 64, 15 * 32)


def _state(run):
    return [leaf for tree in (run.params, run.opt_state.m, run.opt_state.v,
                              run.opt_state.master)
            for leaf in tree_leaves(tree)]


@pytest.mark.parametrize("arch,shape", [("bst", "train_batch"),
                                        ("nequip", "molecule")])
def test_train_main_checkpoints_and_resumes_bit_equal(tmp_path, arch, shape):
    argv = ["--arch", arch, "--shape", shape, "--smoke", "--device", "cpu"]
    whole = train.main(argv + ["--steps", "4"])
    assert whole.start == 0 and len(whole.history) == 4
    assert all(np.isfinite(r["loss"]) for r in whole.history)
    metric = "bce" if arch == "bst" else "mse"
    assert whole.history[0][metric] == whole.history[0]["loss"]
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = train.main(argv + ck + ["--steps", "2"])
    assert [r["loss"] for r in first.history] == [
        r["loss"] for r in whole.history[:2]]
    resumed = train.main(argv + ck + ["--steps", "4"])
    assert resumed.start == 2
    assert [r["loss"] for r in resumed.history] == [
        r["loss"] for r in whole.history[2:]]
    assert int(resumed.opt_state.step) == 4
    for a, b in zip(_state(resumed), _state(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)      # bit for bit
    manifest = json.loads((tmp_path / "step_0000000004" / "manifest.json")
                          .read_text())
    key = ("params/blocks/0/wq" if arch == "bst"
           else "params/layers/self_mix/2")
    assert key in manifest["arrays"]


def test_reference_bst_checkpoint_restores_bit_for_bit(tmp_path):
    """The reference writes a BST checkpoint (float32; list-of-dict keys
    ``params/head/0/w``, ``opt/.m/blocks/0/ff1``); the launcher resumes
    it into the same numbers."""
    jparams = jsteps.init_fn(jbst.ARCH, "train_batch", smoke=True)(
        jax.random.PRNGKey(3))
    jopt = jsteps.make_optimizer("recsys")
    jstate = jopt.init(jparams)
    jstep = jax.jit(jsteps.make_step(jbst.ARCH, "train_batch", "train",
                                     smoke=True))
    jparams, jstate, _ = jstep(jparams, jstate, jtrain.synthetic_batch(
        jbst.ARCH, "train_batch", True, 0))
    jck.save_checkpoint(tmp_path, 1, {"params": jparams, "opt": jstate})
    manifest = json.loads((tmp_path / "step_0000000001" / "manifest.json")
                          .read_text())
    assert {"params/head/0/w", "opt/.m/blocks/0/ff1"} <= set(
        manifest["arrays"])
    run = train.main(["--arch", "bst", "--smoke", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path), "--steps", "1"])
    assert run.start == 1 and run.history == []
    assert int(run.opt_state.step) == 1
    for tree, jtree in ((run.params, jparams), (run.opt_state.m, jstate.m),
                        (run.opt_state.v, jstate.v),
                        (run.opt_state.master, jstate.master)):
        for t, a in zip(tree_leaves(tree), jax.tree.leaves(jtree)):
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def test_train_main_refuses_cuts_an_arch_cannot_take(capsys):
    run = train.main(["--arch", "dlrm-rm2", "--smoke", "--device", "cpu",
                      "--steps", "1", "--batch", "8"])
    assert "train_batch: batch CUT from 65536 to 8 samples" in \
        capsys.readouterr().out
    assert len(run.history) == 1
    with pytest.raises(SystemExit):
        train.main(["--arch", "mind", "--smoke", "--device", "cpu",
                    "--layers", "1"])
    assert "has no layer count to cut" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        train.main(["--arch", "nequip", "--smoke", "--device", "cpu",
                    "--batch", "8"])
    assert "no batch axis" in capsys.readouterr().err
    run = train.main(["--arch", "nequip", "--smoke", "--device", "cpu",
                      "--steps", "1", "--layers", "1"])
    assert "depth CUT from 2 to 1 layers" in capsys.readouterr().out
    assert run.params["layers"]["gate_w"].shape[0] == 1
    assert registry.get_arch("nequip").smoke_config.n_layers == 2

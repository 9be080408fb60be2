"""The port's checkpoints against the reference's on-disk format, on the
CPU: bfloat16 bit for bit, NamedTuple fields keyed as jax keys them
(``opt/.m/<path>``), and a checkpoint written by either package read by
the other.

The reference writes bf16 as ``np.savez`` stores an ``ml_dtypes`` array,
the 2-byte void ``|V2``, with ``"bfloat16"`` in the manifest; the port
writes the same through a ``uint16`` view and restores by the manifest's
dtype into a ``torch.bfloat16`` tensor.  The reference cannot read bf16
back (``jnp.asarray`` refuses ``|V2``): a test pins that fault, so the
float32 round trips go both ways and bf16 only from the reference to the
port.  Every comparison is exact.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro.train.optimizer import AdamW as JAdamW
from repro_torch.checkpoint import Checkpointer, checkpointer as ck
from repro_torch.train.optimizer import AdamW, AdamWState

pytestmark = pytest.mark.torch_port


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"embed": rng.normal(size=(8, 4)).astype(np.float32),
            "layers": {"wq": rng.normal(size=(4, 4, 2)).astype(np.float32),
                       "router": rng.normal(size=(4, 3)).astype(np.float32)},
            "ln_f": np.ones(4, np.float32)}


def _torch_tree(arrays, dtype):
    def conv(a):
        return torch.tensor(a).to(dtype)
    return {"embed": conv(arrays["embed"]),
            "layers": {k: conv(v) for k, v in arrays["layers"].items()},
            "ln_f": conv(arrays["ln_f"])}


def _jax_tree(arrays, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), arrays)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("async_save", [False, True])
def test_bf16_round_trip_bit_for_bit(tmp_path, n_shards, async_save):
    """bf16 (NaN, inf, subnormals, -0 included) and float32 leaves saved
    and restored exactly; the manifest and npz types are the
    reference's."""
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                            1e-40, 3.0e38, -1.5, 65504.0],
                           dtype=torch.float32).to(torch.bfloat16)
    tree = {"a": torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
            .to(torch.bfloat16), "b": special.reshape(4, 2),
            "c": torch.arange(6, dtype=torch.float32),
            "t": torch.randn(8, 3).to(torch.bfloat16).t()}   # strided view
    saver = Checkpointer(tmp_path, async_save=async_save, n_shards=n_shards)
    saver.save(3, tree)
    saved_a = tree["a"].clone()
    tree["a"].add_(1)           # after save(): must not reach the file
    saver.wait()
    manifest = json.loads((tmp_path / "step_0000000003" / "manifest.json")
                          .read_text())
    assert manifest["arrays"]["a"]["dtype"] == "bfloat16"
    assert manifest["arrays"]["c"]["dtype"] == "float32"
    with np.load(tmp_path / "step_0000000003" / "shard_0.npz") as z:
        assert z["a"].dtype == np.dtype("V2")
    step, back = saver.restore_latest(tree)
    assert step == 3
    for k in ("a", "b", "t"):
        assert back[k].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(back["a"]), _bits(saved_a))
    np.testing.assert_array_equal(_bits(back["b"]), _bits(tree["b"]))
    np.testing.assert_array_equal(_bits(back["t"]),
                                  _bits(tree["t"].contiguous()))
    np.testing.assert_array_equal(back["c"], tree["c"].numpy())


def test_namedtuple_keys_are_the_references(tmp_path):
    """The port's {"params", "opt": AdamWState} checkpoint has the
    reference's keys, shapes and dtypes; plain tuples keep indices."""
    arrays = _arrays()
    params = _torch_tree(arrays, torch.bfloat16)
    jparams = _jax_tree(arrays, jnp.bfloat16)
    state, jstate = AdamW().init(params), JAdamW().init(jparams)
    ck.save_checkpoint(tmp_path / "port", 1, {"params": params,
                                              "opt": state})
    jck.save_checkpoint(tmp_path / "ref", 1, {"params": jparams,
                                              "opt": jstate})
    ours, theirs = (json.loads((tmp_path / d / "step_0000000001" /
                                "manifest.json").read_text())["arrays"]
                    for d in ("port", "ref"))
    assert ours == theirs
    assert "opt/.master/layers/wq" in ours and "opt/.step" in ours
    assert [k for k, _ in ck._flatten_with_paths({"x": (1, [2, 3])})] == [
        "x/0", "x/1/0", "x/1/1"]
    rebuilt = ck._unflatten(state, dict(ck._flatten_with_paths(state)))
    assert isinstance(rebuilt, AdamWState) and rebuilt.m is not state.m


def test_float32_checkpoints_resume_in_both_packages(tmp_path):
    """float32 params and AdamW state: the reference restores the port's
    checkpoint and the port the reference's, every leaf exact."""
    arrays = _arrays(1)
    params = _torch_tree(arrays, torch.float32)
    state = AdamW().init(params)
    grads = _torch_tree(_arrays(2), torch.float32)
    params, state, _ = AdamW().update(params, state, grads)
    ck.save_checkpoint(tmp_path / "port", 1, {"params": params,
                                              "opt": state})
    jparams = _jax_tree(arrays, jnp.float32)
    jstate = JAdamW().init(jparams)
    step, restored = jck.restore_checkpoint(tmp_path / "port",
                                            {"params": jparams,
                                             "opt": jstate})
    assert step == 1 and int(restored["opt"].step) == 1
    flat = dict(ck._flatten_with_paths({"params": params, "opt": state}))
    for key, leaf in jck._flatten_with_paths(restored):
        np.testing.assert_array_equal(np.asarray(leaf),
                                      torch.as_tensor(flat[key]).numpy())

    jgrads = _jax_tree(_arrays(3), jnp.float32)
    jparams, jstate, _ = JAdamW().update(jparams, jstate, jgrads)
    jck.save_checkpoint(tmp_path / "ref", 2, {"params": jparams,
                                              "opt": jstate})
    step, back = ck.restore_checkpoint(tmp_path / "ref",
                                       {"params": params, "opt": state})
    assert step == 2 and isinstance(back["opt"], AdamWState)
    assert back["opt"].step.dtype == np.int32 and int(back["opt"].step) == 1
    jflat = dict(jck._flatten_with_paths({"params": jparams,
                                          "opt": jstate}))
    for key, leaf in ck._flatten_with_paths(back):
        np.testing.assert_array_equal(leaf, np.asarray(jflat[key]))


def test_port_reads_a_reference_bf16_checkpoint_bit_for_bit(tmp_path):
    arrays = _arrays(4)
    jparams = _jax_tree(arrays, jnp.bfloat16)
    jstate = JAdamW().init(jparams)
    jck.save_checkpoint(tmp_path, 5, {"params": jparams, "opt": jstate})
    like = {"params": _torch_tree(arrays, torch.bfloat16),
            "opt": AdamW().init(_torch_tree(arrays, torch.bfloat16))}
    step, back = ck.restore_checkpoint(tmp_path, like)
    assert step == 5
    jflat = dict(jck._flatten_with_paths({"params": jparams,
                                          "opt": jstate}))
    for key, leaf in ck._flatten_with_paths(back):
        want = np.asarray(jflat[key])
        if key.startswith("params/"):
            assert leaf.dtype == torch.bfloat16, key
            np.testing.assert_array_equal(_bits(leaf),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(leaf, want)


def test_reference_cannot_restore_its_own_bf16_checkpoint(tmp_path):
    """The documented fault of the reference (ROADMAP.md §3): its restore
    hands the ``|V2`` array to ``jnp.asarray``, which refuses it, so
    ``repro.launch.train --ckpt-dir`` cannot resume a bf16 model."""
    jparams = _jax_tree(_arrays(5), jnp.bfloat16)
    jck.save_checkpoint(tmp_path, 1, {"params": jparams})
    with pytest.raises(TypeError, match="V2"):
        jck.restore_checkpoint(tmp_path, {"params": jparams})

"""The port's checkpoints and training loop: twins of tests/
test_checkpoint.py, and checkpoints crossing between the two packages.

A checkpoint written by either package restores in the other bit for bit
(bf16 leaves stored as raw bytes, the int32 step, float32 moments), with
the same manifest: leaf keys, files, shapes, dtype names and hashes.
Tolerances: the optimizer's twins are the reference's (the residual
within 1e-6 of the quantization error; the loss under a tenth of its
start after 60 steps).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import checkpoint as JCKPT
from repro.training import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.loop import LoopConfig, run_training
from repro_torch.training.optimizer import (AdamWState, adamw_init,
                                            adamw_update, compress_grads,
                                            decompress_grads)
from repro_torch.training.train_step import make_train_step
from repro_torch.training.tree import leaves, leaves_with_paths, path_key


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=g),
            "b": {"c": torch.arange(10, dtype=torch.int32),
                  "d": torch.randn((3,), generator=g).to(torch.bfloat16)}}


def test_roundtrip(tmp_path):
    t = _tree()
    CKPT.save_checkpoint(str(tmp_path), 7, t)
    restored, step = CKPT.restore_checkpoint(str(tmp_path), t)
    assert step == 7
    for a, b in zip(leaves(t), leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_and_gc(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        CKPT.save_checkpoint(str(tmp_path), s, t, keep_last=2)
    assert CKPT.latest_step(str(tmp_path)) == 5
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_0000000004", "step_0000000005"]


def test_corruption_detected(tmp_path):
    t = _tree()
    path = CKPT.save_checkpoint(str(tmp_path), 1, t)
    victim = [f for f in os.listdir(path) if f.endswith(".npy")][0]
    arr = np.load(os.path.join(path, victim))
    np.save(os.path.join(path, victim), arr + 1)
    with pytest.raises(IOError):
        CKPT.restore_checkpoint(str(tmp_path), t)


def test_no_partial_checkpoint_on_crash(tmp_path):
    """tmp dirs from interrupted writes must never be listed as steps."""
    os.makedirs(tmp_path / ".tmp_ckpt_dead")
    assert CKPT.latest_step(str(tmp_path)) is None
    CKPT.save_checkpoint(str(tmp_path), 2, _tree())
    assert CKPT.latest_step(str(tmp_path)) == 2


def test_loop_resume_and_failure_injection(tmp_path):
    """Train 10 steps with a ckpt every 4; crash at step 7; rerun: the loop
    resumes from step 8 (not 0) and finishes; injected transient failures
    are retried."""
    cfg = get_config("granite-8b").reduced(n_layers=1, d_model=32,
                                           n_heads=2, n_kv_heads=2,
                                           d_head=16, d_ff=32)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, remat=False)
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 16)))} for _ in range(12)]

    boom = {"armed": True}

    def injector(step):
        if step == 7 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated preemption")

    cfg_loop = LoopConfig(total_steps=10, ckpt_every=4,
                          ckpt_dir=str(tmp_path))
    p1, o1, rep1 = run_training(step_fn, params, opt, batches, cfg_loop,
                                failure_injector=injector)
    assert rep1.steps_run == 10
    assert rep1.retries == 1            # the injected failure was retried
    assert int(o1.step) == 10 and len(rep1.step_seconds) == 10

    # second run resumes from the last checkpoint, not from scratch
    p2, o2, rep2 = run_training(step_fn, params, opt, batches,
                                LoopConfig(total_steps=10, ckpt_every=4,
                                           ckpt_dir=str(tmp_path)))
    assert rep2.resumed_from == 8
    assert rep2.steps_run == 2
    # steps 9 and 10 from step 8's checkpoint give the first run's state
    for a, b in zip(leaves((p1, o1)), leaves((p2, o2))):
        assert torch.equal(a, b)


def test_restore_to_a_given_device(tmp_path):
    """The counterpart of the reference's restore under shardings: the
    leaves land on the device asked for, whatever `like` holds."""
    t = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    CKPT.save_checkpoint(str(tmp_path), 3, t)
    like = {"w": torch.empty((8, 8), device="meta")}
    restored, _ = CKPT.restore_checkpoint(str(tmp_path), like,
                                          device="cpu")
    assert restored["w"].device.type == "cpu"
    assert torch.equal(restored["w"], t["w"])
    with pytest.raises(KeyError):
        CKPT.restore_checkpoint(str(tmp_path), {"x": t["w"]})


def test_gradient_compression_error_feedback():
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=(64,)).astype(np.float32))}
    q, scales, resid = compress_grads(g, None)
    assert q["w"].dtype == torch.int8
    deq = decompress_grads(q, scales)
    err1 = float((deq["w"] - g["w"]).abs().max())
    assert err1 < float(scales["w"]) + 1e-6
    # residual carries exactly the quantization error
    np.testing.assert_allclose(resid["w"].numpy(),
                               (g["w"] - deq["w"]).numpy(), atol=1e-6)


def test_adamw_decreases_loss():
    rng = np.random.default_rng(0)
    w_true = torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    y = x @ w_true
    params = {"w": torch.zeros(8)}
    opt = adamw_init(params)

    def loss_fn(p):
        return ((x @ p["w"] - y) ** 2).mean()

    l0 = float(loss_fn(params))
    for _ in range(60):
        w = params["w"].clone().requires_grad_(True)
        g = torch.autograd.grad(loss_fn({"w": w}), w)[0]
        params, opt = adamw_update({"w": g}, opt, params, lr=0.05,
                                   weight_decay=0.0)
    assert float(loss_fn(params)) < 0.1 * l0


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

def _cross_state(seed=1):
    """(JAX tree, port tree) of one (params, AdamWState) with a bf16 leaf,
    the int32 step and float32 moments; equal bit for bit."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    n = rng.normal(size=(6,)).astype(np.float32)
    m = {"embed": rng.normal(size=(4, 6)).astype(np.float32),
         "final_norm": rng.normal(size=(6,)).astype(np.float32)}
    v = {k: np.abs(a) for k, a in m.items()}
    jt = ({"embed": jnp.asarray(w).astype(jnp.bfloat16),
           "final_norm": jnp.asarray(n)},
          jopt.AdamWState(step=jnp.asarray(5, jnp.int32),
                          m=jax.tree.map(jnp.asarray, m),
                          v=jax.tree.map(jnp.asarray, v)))
    tt = ({"embed": torch.from_numpy(w).to(torch.bfloat16),
           "final_norm": torch.from_numpy(n)},
          AdamWState(step=torch.tensor(5, dtype=torch.int32),
                     m=jax.tree.map(torch.from_numpy, m),
                     v=jax.tree.map(torch.from_numpy, v)))
    return jt, tt


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.uint8) if x.dtype == torch.bfloat16
                else x).numpy().tobytes()
    return np.asarray(x).tobytes()


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_both_packages_write_the_same_checkpoint(tmp_path):
    jt, tt = _cross_state()
    jpath = JCKPT.save_checkpoint(str(tmp_path / "jax"), 5, jt)
    tpath = CKPT.save_checkpoint(str(tmp_path / "port"), 5, tt)
    jm, tm = _manifest(jpath), _manifest(tpath)
    assert jm == tm
    assert sorted(jm["leaves"]) == ["0/embed", "0/final_norm", "1/m/embed",
                                    "1/m/final_norm", "1/step", "1/v/embed",
                                    "1/v/final_norm"]
    assert jm["leaves"]["0/embed"]["dtype"] == "bfloat16"
    assert jm["leaves"]["1/step"]["dtype"] == "int32"
    for meta in jm["leaves"].values():
        a = np.load(os.path.join(jpath, meta["file"]))
        b = np.load(os.path.join(tpath, meta["file"]))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_port_restores_a_jax_checkpoint_bit_for_bit(tmp_path):
    jt, tt = _cross_state(2)
    JCKPT.save_checkpoint(str(tmp_path), 5, jt)
    like = jax.tree.map(torch.zeros_like, tt)
    (params, opt), step = CKPT.restore_checkpoint(str(tmp_path), like)
    assert step == 5 and isinstance(opt, AdamWState)
    assert opt.step.dtype == torch.int32 and int(opt.step) == 5
    assert params["embed"].dtype == torch.bfloat16
    want = {path_key(p): x for p, x in leaves_with_paths(tt)}
    for p, x in leaves_with_paths((params, opt)):
        assert x.dtype == want[path_key(p)].dtype
        assert _bits(x) == _bits(want[path_key(p)])


def test_jax_restores_a_port_checkpoint_bit_for_bit(tmp_path):
    jt, tt = _cross_state(3)
    CKPT.save_checkpoint(str(tmp_path), 5, tt)
    like = jax.tree.map(jnp.zeros_like, jt)
    restored, step = JCKPT.restore_checkpoint(str(tmp_path), like)
    assert step == 5
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jt)):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)
    # a flipped byte fails the reference's hash check too
    path = os.path.join(str(tmp_path), "step_0000000005")
    meta = _manifest(path)["leaves"]["0/embed"]
    arr = np.load(os.path.join(path, meta["file"]))
    arr[0] ^= 1
    np.save(os.path.join(path, meta["file"]), arr)
    with pytest.raises(IOError):
        JCKPT.restore_checkpoint(str(tmp_path), like)
    with pytest.raises(IOError):
        CKPT.restore_checkpoint(str(tmp_path), tt)

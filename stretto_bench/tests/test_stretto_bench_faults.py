"""A run with the timed path broken underneath comes out not correct.

Each cell runs at tiny widths on the CPU through `harness.run_cell` (the
look for a card is `run.py`'s, skipped here) with one fault planted in
the port's entry point, and the cell's own limits decide: once sound,
then once per fault the cell can have. One card, so no exchange between
cards to leave out. The control, the reference in float8, fails the
same limits."""
import pytest
import torch

from stretto_bench import harness
from stretto_bench_tiny import tiny_root

FLUSH_CELLS = ["granite-8b-l4.gold_flush_long",
               "deepseek-v2-lite-16b-l8.gold_flush_long"]
PREFILL_CELLS = ["granite-8b-l4.prefill_long"]
SEED = 2 ** 31 + 99


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(autouse=True)
def default_switches(monkeypatch):
    """The port's switches at their defaults, as `run.py` leaves them."""
    for key in ("STRETTO_TORCH_KERNELS", "STRETTO_FUSED"):
        monkeypatch.delenv(key, raising=False)


def run(root, name):
    return harness.run_cell(name, SEED, 0.3, False, device="cpu", root=root)


def unchanged(orig):
    """Every flush hands back the first flush's logits."""
    first = []

    def step(*a, **k):
        out = orig(*a, **k)
        if not first:
            first.append(out[0].clone())
        return first[0], out[1]
    return step


def half_batch(orig):
    """Only the first half of the items is decoded; the rest get the mean
    of those."""
    def step(params, cfg, cache, tokens=None, **k):
        B = tokens.shape[0]
        h = B // 2
        sub = {n: (t[:h] if n == "lengths" else t[:, :h])
               for n, t in cache.items()}
        logits, _ = orig(params, cfg, sub, tokens=tokens[:h], **k)
        out = logits.mean(0, keepdim=True).expand(B, -1).clone()
        out[:h] = logits
        return out, cache
    return step


def altered(orig):
    """One item's logits come out shifted by one token."""
    def step(*a, **k):
        logits, cache = orig(*a, **k)
        logits = logits.clone()
        logits[0] = logits[0].roll(1)
        return logits, cache
    return step


@pytest.mark.parametrize("name", FLUSH_CELLS)
@pytest.mark.parametrize("fault", [None, unchanged, half_batch, altered])
def test_flush_faults_fail(root, name, fault, monkeypatch):
    import repro_torch.models as M
    if fault is not None:
        for fn in ("decode_multi", "decode_step"):
            monkeypatch.setattr(M, fn, fault(getattr(M, fn)))
    line = run(root, name)
    assert line["correct"] is (fault is None), line["checks"]


def unwritten(orig):
    """The prefill leaves the cache it returns unwritten."""
    def step(*a, **k):
        logits, cache = orig(*a, **k)
        for n in ("k", "v"):
            cache[n].zero_()
        return logits, cache
    return step


def first_item_only(orig):
    """Only the first prompt is prefilled; the other items get its
    outputs."""
    def step(params, cfg, tokens=None, lengths=None, **k):
        B = tokens.shape[0]
        logits, cache = orig(params, cfg, tokens=tokens[:1],
                             lengths=lengths[:1], **k)
        out = {n: (lengths if n == "lengths" else
                   t.expand((t.shape[0], B) + t.shape[2:]).contiguous())
               for n, t in cache.items()}
        return logits.expand(B, -1).contiguous(), out
    return step


def altered_row(orig):
    """One cached key row of the first item comes out negated."""
    def step(*a, **k):
        logits, cache = orig(*a, **k)
        cache["k"][0, 0, 3] = -cache["k"][0, 0, 3]
        return logits, cache
    return step


@pytest.mark.parametrize("name", PREFILL_CELLS)
@pytest.mark.parametrize("fault", [None, unwritten, first_item_only,
                                   altered_row])
def test_prefill_faults_fail(root, name, fault, monkeypatch):
    import repro_torch.models as M
    if fault is not None:
        monkeypatch.setattr(M, "prefill", fault(M.prefill))
    line = run(root, name)
    assert line["correct"] is (fault is None), line["checks"]


@pytest.mark.parametrize("name", FLUSH_CELLS + PREFILL_CELLS)
def test_the_control_fails_the_limits(root, name):
    cell = harness.load_cell(name, root)
    traffic = harness.load_module(
        root / "stretto_bench" / "traffic" / f"{cell.workload['kind']}.py",
        "stretto_bench_traffic_control")
    ctx = harness.Context(cell=cell, seed=SEED, seconds=0.0, trace=False,
                          device=torch.device("cpu"), t0=0.0)
    ctx.cfg = harness.port_config(cell.model)
    values = traffic.control(ctx)
    limits = cell.workload["limits"]
    assert any(v > limits[k] for k, v in values.items()), (values, limits)

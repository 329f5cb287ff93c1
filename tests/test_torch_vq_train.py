"""The EMA-VQ training forward (quantize/vq.py) against the JAX package's
EMAVectorQuantizer and Bottleneck, on the CPU in float32.

The restart candidates are the one drawn part: JAX draws them from
`jax.random`, the port from a CPU torch.Generator, and torch cannot
reproduce JAX's stream. So the deterministic parts are held against JAX
with JAX's own candidates handed to the port (`jax_candidates`: JAX's
module-level `_tile_candidates` runs with the key its call uses and
records what it drew, which the port's `_tile_candidates` then returns), and
the port's own draws are held by their properties.

Tolerances: labels and `initted` equal; codebook, EMA sums, outputs and
metrics within float32 rounding (rtol 1e-5, atol 1e-6: sums of at most a
few dozen terms); three consecutive calls from an uninitialised codebook.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import speech_inpainting_tpu.quantize.vq as jvq
import speech_inpainting_torch.quantize.vq as pvq
from speech_inpainting_torch.quantize.vq import Bottleneck, EMAVectorQuantizer

METRICS = ["dk", "entropy", "fit", "pn", "usage", "used_curr"]
BUFFERS = ("k", "k_sum", "k_elem", "initted")


@pytest.fixture
def jax_candidates(monkeypatch):
    """JAX's candidates, recorded as its calls draw them and handed, in
    order, to the port's calls in place of the port's own draws."""
    drawn = []
    orig = jvq._tile_candidates

    def record(key, x, k_bins):
        cand = orig(key, x, k_bins)
        jax.debug.callback(lambda c: drawn.append(np.array(c)), cand)
        return cand

    def replay(gen, x, k_bins):
        return torch.from_numpy(drawn.pop(0)).to(x.device, x.dtype)

    monkeypatch.setattr(jvq, "_tile_candidates", record)
    monkeypatch.setattr(pvq, "_tile_candidates", replay)
    return drawn


def _empty(levels, bins, width):
    return {f"level_{i}": {"k": np.zeros((bins, width), np.float32),
                           "k_sum": np.zeros((bins, width), np.float32),
                           "k_elem": np.zeros(bins, np.float32),
                           "initted": np.zeros((), bool)}
            for i in range(levels)}


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=1e-5, atol=1e-6, err_msg=what)


def _check_block(port, jvars, what):
    for name in BUFFERS:
        got = getattr(port, name)
        if name == "initted":
            assert bool(got) == bool(jvars[name]), what
        else:
            _close(got, jvars[name], f"{what} {name}")


# (k_bins, emb_width, input width, (N, T)): N·T frames against k_bins
CASES = {
    "frames_over_bins": (16, 8, 8, (2, 12)),       # 24 ≥ 16 rows
    "frames_under_bins": (12, 8, 8, (1, 5)),       # 5 < 12: tiled, jittered
    "summed_halves": (16, 8, 16, (2, 12)),         # a 2·emb_width input
}


@pytest.mark.parametrize("case", list(CASES))
def test_training_forward_matches_jax(rng, jax_candidates, case):
    bins, width, c_in, (n, t) = CASES[case]
    jq = jvq.EMAVectorQuantizer(bins, width)
    port = EMAVectorQuantizer(bins, width)
    jvars = _empty(1, bins, width)["level_0"]
    restarted = 0
    for call in range(3):
        x = rng.standard_normal((n, c_in, t)).astype(np.float32)
        (labels, x_q, commit, metrics), upd = jq.apply(
            {"vq": jvars}, jnp.asarray(x), train=True,
            rngs={"vq": jax.random.PRNGKey(call)}, mutable=["vq"])
        jvars = upd["vq"]
        cand = jax_candidates[0].copy()
        xt = torch.tensor(x, requires_grad=True)
        got = port(xt, train=True)
        assert not jax_candidates
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(labels))
        _close(got[1], x_q, "output")
        _close(got[2], commit, "commit")
        assert sorted(got[3]) == sorted(metrics) == METRICS
        for k in METRICS:
            _close(got[3][k], metrics[k], k)
        _check_block(port, jvars, f"call {call}")
        # dead codes read k_elem < 1 and restart at their candidate
        dead = port.k_elem.numpy() < 1.0
        np.testing.assert_array_equal(port.k.numpy()[dead], cand[dead])
        restarted += int(dead.sum())
        assert int(got[3]["usage"]) == bins - int(dead.sum())
        # gradient reaches the input through the straight-through path only
        (got[1].sum() + got[2]).backward()
        assert xt.grad is not None and torch.isfinite(xt.grad).all()
    assert restarted > 0
    if case == "frames_under_bins":       # restarts from the first call
        assert int(metrics["usage"]) < bins


def test_bottleneck_training_forward_matches_jax(rng, jax_candidates):
    """Two levels, each updated with its own candidates (update_k=train)."""
    jb = jvq.Bottleneck(2, 8, 8)
    port = Bottleneck(2, 8, 8)
    jvars = _empty(2, 8, 8)
    for call in range(3):
        xs = [rng.standard_normal((2, 8, t)).astype(np.float32)
              for t in (10, 4)]
        (zs, xqs, commits, metrics), upd = jb.apply(
            {"vq": jvars}, [jnp.asarray(x) for x in xs], train=True,
            rngs={"vq": jax.random.PRNGKey(10 + call)}, mutable=["vq"])
        jvars = upd["vq"]
        got = port([torch.tensor(x) for x in xs], train=True)
        assert not jax_candidates
        for level in range(2):
            np.testing.assert_array_equal(got[0][level].numpy(),
                                          np.asarray(zs[level]))
            _close(got[1][level], xqs[level], "output")
            _close(got[2][level], commits[level], "commit")
            _check_block(getattr(port, f"level_{level}"),
                         jvars[f"level_{level}"], f"level {level}")


def test_eval_after_training_matches_jax(rng, jax_candidates):
    """After a training call, the eval forward reads the updated codebook
    and leaves every buffer as it was."""
    jq, port = jvq.EMAVectorQuantizer(8, 8), EMAVectorQuantizer(8, 8)
    x = rng.standard_normal((2, 8, 12)).astype(np.float32)
    _, upd = jq.apply({"vq": _empty(1, 8, 8)["level_0"]}, jnp.asarray(x),
                      train=True, rngs={"vq": jax.random.PRNGKey(0)},
                      mutable=["vq"])
    port(torch.tensor(x), train=True)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    y = rng.standard_normal((2, 8, 7)).astype(np.float32)
    labels, x_q, commit, _ = jq.apply(upd, jnp.asarray(y))
    got = port(torch.tensor(y))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(labels))
    _close(got[1], x_q, "output")
    _close(got[2], commit, "commit")
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("n", [24, 5])
def test_own_candidates_by_their_properties(rng, n):
    """The port's draws: k_bins distinct rows of the input when it has
    enough (each row taken at most once), else rows of its tiling each
    within 5σ of the jitter (σ = 0.01/√d) of an input row, no row more
    often than its tiles; the same seed draws the same candidates, another
    seed others."""
    bins, d = 12, 8
    x = torch.tensor(rng.standard_normal((n, d)).astype(np.float32))
    draw = lambda seed: pvq._tile_candidates(  # noqa: E731
        torch.Generator().manual_seed(seed), x, bins)
    cand = draw(0)
    assert cand.shape == (bins, d)
    gap = (cand[:, None, :] - x[None, :, :]).abs().amax(-1)   # (bins, n)
    nearest = gap.argmin(1)
    if n >= bins:
        assert (gap.amin(1) == 0).all()
        assert len(set(nearest.tolist())) == bins
    else:
        assert (gap.amin(1) <= 5 * 0.01 / d ** 0.5).all()
        assert (gap.amin(1) > 0).all()
        reps = -(-bins // n)
        assert np.bincount(nearest.numpy(), minlength=n).max() <= reps
        assert len({tuple(r) for r in cand.tolist()}) == bins
    assert torch.equal(draw(0), cand)
    assert not torch.equal(draw(1), cand)

"""The port's run utilities (utils/config.py, utils/timing.py,
utils/profiling.py) against the JAX package's, on the CPU:
  - config: build/merge/load_config precedence over the same JSON and YAML
    files, unknown keys refused by both, save_config's file, the resolved
    dicts equal through both packages; the shipped configs/*.json built
    through the port's config classes (tests/test_utils.py's checks);
  - timing: differenced_time and differenced_or_fallback give JAX's
    numbers (and JAX's retries) on the same fake run_window; force and
    timeit wait on every tensor leaf;
  - profiling: ThroughputMeter equal to JAX's on the same fake clock,
    estimate_cost's flops of a matmul 2·M·N·K as JAX's cost analysis
    counts them, measure's keys, and trace writing a Chrome trace.
"""
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from speech_inpainting_tpu.utils import config as jconfig
from speech_inpainting_tpu.utils import profiling as jprof
from speech_inpainting_tpu.utils import timing as jtiming
from speech_inpainting_torch.utils import config as pconfig
from speech_inpainting_torch.utils import profiling as pprof
from speech_inpainting_torch.utils import timing as ptiming

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass(frozen=True)
class Inner:
    lr: float = 1e-4
    sizes: tuple = (1, 2)


@dataclasses.dataclass(frozen=True)
class Outer:
    name: str = "x"
    inner: Inner = Inner()
    n: int = 3


def test_config_precedence_and_refusals_match_jax(tmp_path):
    cfg = pconfig.build(Outer, {"name": "y", "inner": {"lr": 2e-3}})
    assert cfg == Outer("y", Inner(2e-3, (1, 2)))
    f1 = tmp_path / "a.json"
    f1.write_text(json.dumps({"n": 5, "inner": {"sizes": [4, 5, 6],
                                                "lr": 3}}))
    f2 = tmp_path / "b.yaml"
    f2.write_text("inner:\n  lr: 0.5\nn: '7'\n")
    sources = (f1, f2, {"name": "m"})
    got = pconfig.load_config(Outer, *sources, overrides={"name": "z"})
    want = jconfig.load_config(Outer, *sources, overrides={"name": "z"})
    assert got == want == Outer("z", Inner(0.5, (4, 5, 6)), 7)  # later wins
    assert pconfig.to_dict(got) == jconfig.to_dict(want)
    # without the YAML file, the JSON's int lr becomes the field's float
    one = pconfig.load_config(Outer, f1)
    assert one.inner.lr == 3.0 and isinstance(one.inner.lr, float)
    assert one == jconfig.load_config(Outer, f1)
    for mod in (pconfig, jconfig):
        with pytest.raises(KeyError, match="bogus"):
            mod.merge(Outer, got, {"bogus": 1})
        with pytest.raises(KeyError, match="unknown config keys for Inner"):
            mod.build(Outer, {"inner": {"lr": 1.0, "wd": 0.1}})
    pconfig.save_config(got, tmp_path / "port.json")
    jconfig.save_config(want, tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    assert json.loads((tmp_path / "port.json").read_text())["inner"] == {
        "lr": 0.5, "sizes": [4, 5, 6]}


def test_shipped_configs_build_through_the_port():
    from speech_inpainting_torch.models.codegen import (CodeGeneratorConfig,
                                                        FoVQVAEConfig)
    from speech_inpainting_torch.models.hifigan import HiFiGANConfig
    root = ROOT / "configs"
    read = lambda name: json.loads((root / name).read_text())  # noqa: E731
    h = read("hifigan_v1.json")
    assert HiFiGANConfig.from_dict(h).total_upsample == h["hop_size"] == 256
    g2 = HiFiGANConfig.from_dict(read("hifigan_v2.json"))
    assert g2.upsample_initial_channel == 128 and g2.total_upsample == 256
    g3 = HiFiGANConfig.from_dict(read("hifigan_v3.json"))
    assert g3.resblock == "2" and g3.total_upsample == 256
    hm = read("hifigan_ft_modified.json")
    assert hm["segment_size"] == 44288 and hm["mask_len"] == 20
    assert HiFiGANConfig.from_dict(hm).total_upsample == 256
    c = CodeGeneratorConfig.from_dict(read("da_hubert100_lut.json"))
    assert c.hifigan.in_dim == 384 and c.hifigan.total_upsample == 320
    assert c.f0_quantizer is not None and c.f0_quantizer.l_bins == 20
    fc = FoVQVAEConfig.from_dict(read("f0_vqvae.json"))
    assert fc.emb_width == 128 and fc.encoder.total_stride == 16


def _recorded(fn):
    seen = []

    def run(n):
        seen.append(n)
        return fn(n)
    return run, seen


@pytest.mark.parametrize("window", [
    lambda n: 25.0 + 0.1 * n,                 # a constant cost per window
    lambda n: 30.0 if n <= 2 else 6.0,        # the long window faster
    lambda n: 0.1 * n if n < 12 else 10.0,    # a delta past the short bound
], ids=["constant_cost", "negative_delta", "past_bound"])
def test_differenced_time_matches_jax(window):
    (prun, pseen), (jrun, jseen) = _recorded(window), _recorded(window)
    got = ptiming.differenced_time(prun)
    want = jtiming.differenced_time(jrun)
    assert got == want and pseen == jseen
    assert ptiming.differenced_or_fallback(window, 0.5) == \
        jtiming.differenced_or_fallback(window, 0.5)
    kw = dict(n1=3, n2=9, reps=1, attempts=2)
    assert ptiming.differenced_or_fallback(window, 0.5, **kw) == \
        jtiming.differenced_or_fallback(window, 0.5, **kw)


def test_force_and_timeit_wait_on_every_leaf():
    reads = []

    class Spy(torch.Tensor):
        def cpu(self, *a, **k):
            reads.append(self.shape)
            return super().cpu(*a, **k)

    tree = {"a": torch.ones(3, 4).as_subclass(Spy),
            "b": [torch.zeros(5).as_subclass(Spy),
                  (torch.empty(0), np.ones(2), 1.0)]}
    assert ptiming.force(tree) is tree
    assert reads == [torch.Size([1]), torch.Size([1])]
    calls = []
    s = ptiming.timeit(lambda x: calls.append(x) or torch.ones(2), 7,
                       iters=3, warmup=2)
    assert calls == [7] * 5 and 0 <= s < 1


def test_throughput_meter_matches_jax(monkeypatch):
    clock = iter(np.cumsum([0.5, 0.25, 0.75, 0.5, 1.0, 0.25, 0.5]))
    ticks = [float(t) for t in clock]
    meters = (pprof.ThroughputMeter(window=3), jprof.ThroughputMeter(window=3))
    for m in meters:
        assert m.steps_per_sec == m.audio_sec_per_sec == 0.0
    for i, t in enumerate(ticks):
        monkeypatch.setattr(time, "perf_counter", lambda t=t: t)
        for m in meters:
            m.step(audio_seconds=0.5 * (i + 1))
        (a, b) = meters
        assert a.steps_per_sec == b.steps_per_sec
        assert a.audio_sec_per_sec == b.audio_sec_per_sec
    # the window keeps the last 3 steps (4 times)
    assert meters[0].steps_per_sec == 3 / (ticks[-1] - ticks[-4])


def test_estimate_cost_of_a_matmul_matches_jax(rng):
    M, K, N = 24, 40, 16
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    got = pprof.estimate_cost(torch.matmul, torch.tensor(a), torch.tensor(b))
    want = jprof.estimate_cost(lambda x, y: x @ y, a, b)
    assert got == {"flops": 2.0 * M * N * K}
    assert want["flops"] == got["flops"]
    assert "bytes accessed" not in got       # torch does not count bytes
    assert pprof.estimate_cost(torch.exp, torch.tensor(a)) == {}
    out = pprof.measure(torch.matmul, torch.tensor(a), torch.tensor(b),
                        iters=2)
    assert out.keys() == {"seconds", "gflops", "gflops_per_sec"}
    assert out["gflops"] == 2 * M * N * K / 1e9


def test_trace_writes_a_chrome_trace(tmp_path):
    with pprof.trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])
    assert any("mm" in e.key for e in prof.key_averages())

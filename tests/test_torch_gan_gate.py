"""testing.parity_gate, the gate of the float32 GAN step's parity tests,
against planted faults: one vanilla step of the port, on the CPU at
tests/test_train_variants.py's sizes over reduced discriminators (MPD
periods (2, 3), MSD 2 scales), with a fault planted in its backward (a
hook scaling some parameters' gradients, in its float32 step and in its
float64 step alike), held by test_torch_gan_step.py's `step_gates`
against the JAX step from the same start. Without a fault every gate
passes; with each fault one fails. Run
with `-s`, each case prints each gate's largest share outside and largest
excess (and the fault-free case each tensor's count outside): the planted
side of the readings and the noise that testing.NOISE is set between.
The faults that earlier limits let through are held to those limits too,
to show that they did.
"""
import re

import numpy as np
import pytest
import torch

from speech_inpainting_tpu.train import hifigan as jhg
from speech_inpainting_torch import testing
from speech_inpainting_torch.train import hifigan as phg
from test_torch_gan_guard import REDUCED, reduced_trees
from test_torch_gan_models import _two_threads  # noqa: F401
from test_torch_gan_step import (batches, configs, f64_batch, jax_states,
                                 port_start, step_gates)


def _first_half_shifted(share):
    """A gradient hook adding `share` of the gradient's largest magnitude
    to the first half of its elements only."""
    def hook(g):
        shift = torch.zeros_like(g).reshape(-1)
        shift[:shift.numel() // 2] = share * g.abs().max()
        return g + shift.reshape(g.shape)
    return hook


# (the parameters it touches, by "module.name", and their gradients' factor
# or a hook that changes them)
FAULTS = {
    "none": (r"$^", 1.0),
    "generator_biases_zeroed": (r"generator\..*\.bias$", 0.0),
    "conv_post_doubled": (r"generator\.conv_post\.", 2.0),
    "last_stage_off_by_1e-2": (r"generator\.(ups\.1|resblocks\.1)\.", 1.01),
    "mpd_first_two_convs_zeroed": (r"mpd\..*\.convs\.[01]\.", 0.0),
    "msd_off_by_1e-2": (r"msd\.", 1.01),
    # the two that the limits before NoiseLimits let through: a tensor of at
    # most 16 elements off by an excess under 1000, and half of a larger
    # tensor off within that excess
    "conv_post_bias_off_by_5e-2": (r"generator\.conv_post\.bias$", 1.05),
    "mpd_conv_half_shifted_5e-3": (
        r"mpd\.discriminators\.0\.convs\.1\.weight_v$",
        _first_half_shifted(5e-3)),
    # the one that the limits before small_excess let through: a tensor of
    # at most 16 elements off by an excess under 100
    "conv_post_bias_off_by_5e-3": (r"generator\.conv_post\.bias$", 1.005),
}
# the limits before NoiseLimits: max(16, half) of a tensor's elements
# outside, each within 1000 × its tolerance
OLD = testing.NoiseLimits(share=0.5, excess=1000.0, small_excess=1000.0,
                          least=16)
PASSED_OLD = ("conv_post_bias_off_by_5e-2", "mpd_conv_half_shifted_5e-3",
              "conv_post_bias_off_by_5e-3")
# the limits before small_excess: a tensor of at most 16 elements held to
# the excess of the larger ones, 100 × its tolerance
BEFORE_SMALL = testing.NoiseLimits(share=0.1, excess=100.0,
                                   small_excess=100.0)
PASSED_BEFORE_SMALL = ("conv_post_bias_off_by_5e-3",)


@pytest.fixture(scope="module")
def jax_step():
    jcfg, pcfg = configs()
    tree = reduced_trees(11)
    batch = batches(np.random.default_rng(11), 1)[0]
    (js, _), = jax_states(jcfg, tree, jhg.make_vanilla_step, [batch],
                          **REDUCED)
    return pcfg, tree, batch, js


@pytest.mark.parametrize("fault", list(FAULTS))
def test_gate_fails_on_planted_faults(jax_step, fault):
    pcfg, tree, batch, js = jax_step
    pattern, factor = FAULTS[fault]
    step = phg.make_vanilla_step(pcfg)
    out = []
    for f64, b in ((False, batch), (True, f64_batch(batch))):
        state = port_start(pcfg, tree, f64=f64, **REDUCED)
        hit = 0
        for module in ("generator", "mpd", "msd"):
            for name, p in getattr(state, module).named_parameters():
                if re.match(pattern, f"{module}.{name}"):
                    p.register_hook(factor if callable(factor)
                                    else lambda g, f=factor: g * f)
                    hit += 1
        assert hit or fault == "none"
        out.append(step(state, b)[0])
    reps = step_gates(js, *out)
    print(fault, {what: (rep["share_max"], rep["excess_max"],
                         rep["small_excess_max"], rep["failed"])
                  for what, rep in reps.items()})
    if fault == "none":     # the readings NOISE and NOISE_HELD are set by
        print("outside both gates:", {what: rep["outside"]
                                      for what, rep in reps.items()})
    failed = [what for what, rep in reps.items() if not rep["ok"]]
    assert failed == [] if fault == "none" else failed
    if fault in PASSED_OLD:
        old = step_gates(js, *out, limits=OLD)
        print(fault, "old limits", {what: (rep["share_max"],
                                           rep["excess_max"], rep["failed"])
                                    for what, rep in old.items()})
        assert all(rep["ok"] for rep in old.values())
    if fault in PASSED_BEFORE_SMALL:
        before = step_gates(js, *out, limits=BEFORE_SMALL)
        print(fault, "limits before small_excess",
              {what: (rep["small_excess_max"], rep["failed"])
               for what, rep in before.items()})
        assert all(rep["ok"] for rep in before.values())

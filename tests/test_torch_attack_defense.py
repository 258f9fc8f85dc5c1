"""The attacks through a defense, port against JAX on the CPU: the small ids
defense of tests/test_torch_slice.py (a tiny NVAE and a narrow VGG11-BN
over 10 classes, EoT-4 at initial noise eps 2.0) with its draws frozen:
every call of the net, on both sides, replays the same recorded numpy draws,
so the net is a deterministic function of its input and the two attacks
walk the same trajectory. DeepFool for 3 steps over the top 3 classes (one
lax.while_loop compile on the JAX side), APGD-CE for 4 steps from the same
numpy start, at a bound of 6 (4 steps at 1 to 4 solve neither image). The
JAX side runs jitted: one compile, where its eager dispatch compiles every
operation of the defense's backward apart."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gen_adversarial_tpu.attacks.apgd import apgd_attack as jax_apgd
from gen_adversarial_tpu.attacks.deepfool import deepfool_attack as jax_deepfool
from gen_adversarial_tpu_torch.attacks import apgd_attack, deepfool_attack
from tests.test_torch_slice import _eot_pair, _images, models  # noqa: F401 (fixture)
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

# one torch thread (see the fixture): the suite runs several workers on few cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

KEY = jax.random.PRNGKey(0)
# ~30 float32 layers forward and back in other summation orders, over a few
# attack steps (DeepFool's adversarial images measured 1.7e-6 apart)
TRAJECTORY_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def frozen(models):  # noqa: F811 (the fixture imported above)
    jnet, jax_call, tnet = _eot_pair(models, 2.0, None)
    x = _images(6)
    with torch.no_grad():
        y = tnet(torch.tensor(x)).argmax(1).numpy()
    return dict(jnet=lambda k, v: jnet(v), jax_call=jax_call,
                tnet=lambda v, draws: tnet(v), x=x, y=y)


def _compare(want, got):
    s, bound, adv = (np.asarray(a) for a in want[:3])
    np.testing.assert_array_equal(got[0].numpy(), s)
    assert s.any(), "no sample succeeded: the bounds would not be compared"
    np.testing.assert_allclose(got[1].numpy(), bound, **TRAJECTORY_TOL)
    np.testing.assert_allclose(got[2].numpy(), adv, **TRAJECTORY_TOL)


def test_deepfool_through_the_defense_matches_jax(frozen):
    kw = dict(num_classes=3, overshoot=0.02, max_iter=3, return_iters=True)
    x, y = frozen["x"], frozen["y"]
    want = frozen["jax_call"](lambda: jax.jit(lambda v, w: jax_deepfool(
        KEY, frozen["jnet"], v, w, **kw))(jnp.asarray(x), jnp.asarray(y)))
    got = deepfool_attack(frozen["tnet"], torch.tensor(x), torch.tensor(y), torch.Generator(),
                          **kw)
    assert got[3] == int(want[3])
    _compare(want, got)


def test_apgd_ce_through_the_defense_matches_jax(frozen):
    """APGD's start is the first normal JAX draws while tracing (outside the
    defense's key table, which the frozen net's draws come from)."""
    x, y = frozen["x"], frozen["y"]
    start = np.random.RandomState(9).randn(*x.shape).astype(np.float32)

    def run():
        keyed = jax.random.normal
        pending = [start]

        def fake_normal(k, shape=(), dtype=jnp.float32):
            return jnp.asarray(pending.pop(), dtype) if pending else keyed(k, shape, dtype)

        jax.random.normal = fake_normal
        try:
            return jax.jit(lambda v, w: jax_apgd(KEY, frozen["jnet"], v, w, 4, 0.75, 6.0, True))(
                jnp.asarray(x), jnp.asarray(y))
        finally:
            jax.random.normal = keyed

    want = frozen["jax_call"](run)
    got = apgd_attack(frozen["tnet"], torch.tensor(x), torch.tensor(y), [torch.tensor(start)],
                      4, 0.75, 6.0, True)
    _compare(want, got)

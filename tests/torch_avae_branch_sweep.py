"""How far float32 A-VAE gradients stand from float64 ones, over seeds, on
the CPU: the 64-px critic's input gradient in the JAX package and in the
port, and the port's WGAN-GP d_step + g_step gradients, each against
float64 as it runs and against float64 on the float32 run's leaky-ReLU
branches (models/avae/model.leaky_relu_branches). Where a leaky ReLU's
input lies within rounding of 0 the two precisions take different slopes,
so the first distance jumps at some seeds, in either package; the second
is rounding alone.

    python -m tests.torch_avae_branch_sweep [first seed] [end seed]

Prints one JSON line a seed.
"""

import copy
import json
import sys

import numpy as np


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def main(argv):
    first, end = (int(a) for a in (argv + ["0", "12"])[:2])
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import gen_adversarial_tpu.models.avae.model as javae
    import gen_adversarial_tpu_torch.models.avae.model as tavae
    from gen_adversarial_tpu_torch.models.nvae.distributions import RecordingDraws
    from gen_adversarial_tpu_torch.train.avae import make_avae_trainers
    from tests.torch_port_helpers import load_port, random_variables, to_nchw, to_nhwc

    torch.backends.mkldnn.enabled = False
    jm = javae.AVAEDiscriminator(64)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    taps32 = javae.BINOMIAL3

    def jax_grad(variables, x, cot, dt):
        v = jax.tree.map(lambda a: jnp.asarray(a, dt), variables)
        _, f_vjp = jax.vjp(lambda u: jm.apply(v, u), jnp.asarray(x, dt))
        return np.asarray(f_vjp(jnp.asarray(cot, dt))[0], np.float64)

    def port_grad(module, x, cot, dt):
        xt = to_nchw(x).to(dt).requires_grad_(True)
        out = module.to(dt)(xt)
        return to_nhwc(torch.autograd.grad(out, xt, torch.tensor(cot, dtype=dt))[0])

    def step_grads(t, x, d_draws, g_draws, masks):
        with tavae.leaky_relu_branches(masks) as taken:
            t.d_step(x, d_draws)
            grads = [p.grad.clone() for p in t.disc.parameters()]
            t.g_step(x, g_draws)
        return grads + [p.grad.clone() for p in t.gen.parameters()], taken

    def grads_err(got, want):
        scale = max(w.abs().max().item() for w in want)
        return max((g.double() - w).abs().max().item() for g, w in zip(got, want)) / scale

    for seed in range(first, end):
        rng = np.random.RandomState(100 + seed)
        x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
        cot = rng.standard_normal((1, 1))
        variables = random_variables(shapes, seed)
        jax32 = jax_grad(variables, x, cot, jnp.float32)
        javae.BINOMIAL3 = taps32.astype(np.float64)
        with jax.enable_x64(True):
            jax64 = jax_grad(variables, x, cot, jnp.float64)
        javae.BINOMIAL3 = taps32
        tm = load_port(tavae.AVAEDiscriminator(64, device="cpu"), variables)
        with tavae.leaky_relu_branches() as masks:
            port32 = port_grad(copy.deepcopy(tm), x, cot, torch.float32)
        port64 = port_grad(copy.deepcopy(tm), x, cot, torch.float64)
        with tavae.leaky_relu_branches(masks) as changed:
            port64_b = port_grad(copy.deepcopy(tm), x, cot, torch.float64)
        row = {"seed": seed, "critic_input_grad": {
            "jax_f32_vs_f64": rel_err(jax32, jax64), "port_f32_vs_f64": rel_err(port32, port64),
            "port_f32_vs_f64_on_its_branches": rel_err(port32, port64_b),
            "port_f64_vs_jax_f64": rel_err(port64, jax64),
            "branches_changed": int(sum(int(n) for n in changed))}}

        # one d_step + g_step at 64 px, batch 1, flax's initializers
        t32 = make_avae_trainers(64, 2, 1e-3, device="cpu")
        t32.init(torch.Generator().manual_seed(seed))
        t64 = copy.deepcopy(t32)
        t64.gen.double()
        t64.disc.double()
        real = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(seed)) * 2 - 1
        gen = torch.Generator().manual_seed(1000 + seed)
        d_rec, g_rec = RecordingDraws(gen), RecordingDraws(gen)
        g32, masks = step_grads(t32, real, d_rec, g_rec, None)
        x64 = real.double()
        plain, _ = step_grads(copy.deepcopy(t64), x64, list(d_rec.record),
                              list(g_rec.record), None)
        on_branches, changed = step_grads(t64, x64, list(d_rec.record), list(g_rec.record),
                                          masks)
        row["step_grads"] = {"f32_vs_f64": grads_err(g32, plain),
                             "f32_vs_f64_on_its_branches": grads_err(g32, on_branches),
                             "branches_changed": int(sum(int(n) for n in changed))}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])

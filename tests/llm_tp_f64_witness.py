"""Float64 witness for the hymba variants of ``tests/test_torch_llm_tp.py``
(ROADMAP.md §3, R12): is the port at fault where its two Adam steps miss
``_check_train``'s strict param rule against the reference's, or is the
rule ill-conditioned there?

Each package trains the variant two steps from the same params (the
reference's ``init_params`` at key 0) on the same batch, once in f32 and
once in float64, each run in a process of its own.  For float64 the
f32 names are pointed at float64 before the package loads: the
reference's ``jnp.float32`` (with ``jax_enable_x64``), the port's
``torch.float32``, ``Tensor.float`` and its Adam's numpy bias
corrections; params and batch weights are cast to float64.

It prints, per variant: the losses of the four runs; the largest
gradient and param gaps between the packages in float64; and for every
element that misses the strict rule in any of port f32 vs reference
f32, reference f32 vs float64, port f32 vs float64: the three first
gradients, the param gaps and the rule's limit; then whether the port
passes the variants' widened rule (``_check_variant``) and its worst
widened element in units of LR.

    PYTHONPATH=src python tests/llm_tp_f64_witness.py [variant ...]

(the variants: hymba-cp, hymba-neither, hymba-split; about 40 s each on
one CPU core).  Imports both packages: a test helper, not part of
either package."""
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
VARIANTS = ["hymba-cp", "hymba-neither", "hymba-split"]


def _child(side, prec, name, setup_path, out_path):
    """Two steps of ``name`` in one package at one precision."""
    import functools
    if side == "jax":
        import jax
        if prec == "f64":
            jax.config.update("jax_enable_x64", True)
            import jax.numpy as jnp
            jnp.float32 = jnp.float64
        import jax.numpy as jnp
        import test_torch_llm_tp as T
        from test_torch_llm_sharded import _flat_ref
    else:
        import torch
        if prec == "f64":
            torch.float32 = torch.float64
            torch.Tensor.float = torch.Tensor.double
            torch.set_default_dtype(torch.float64)
        import jax
        import _torch_llm_tp_ranks as ranks
        import test_torch_llm_tp as T
    with open(setup_path, "rb") as f:
        params, batch = pickle.load(f)
    if prec == "f64":
        params = jax.tree_util.tree_map(
            lambda a: a.astype(np.float64) if a.dtype == np.float32 else a,
            params)
        batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                 for k, v in batch.items()}
    if side == "jax":
        cfg = T._ref_config(name)
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        vg = jax.jit(jax.value_and_grad(
            lambda q: T.ref_steps.lm_loss(q, cfg, b), has_aux=True))
        upd = jax.jit(functools.partial(T.ref_adam_update, lr=T.LR))
        p = jax.tree_util.tree_map(jnp.asarray, params)
        opt = T.ref_adam_init(p)
        g1, losses = None, []
        for _ in range(2):
            (loss, _), g = vg(p)
            g1 = g if g1 is None else g1
            p, opt = upd(p, g, opt)
            losses.append(float(loss))
        out = {"grads": _flat_ref(g1), "params": _flat_ref(p),
               "losses": losses}
    else:
        if prec == "f64":
            import types

            import repro_torch.train.optimizer as opt_mod
            fake = types.ModuleType("np")
            fake.__dict__.update(np.__dict__)
            fake.float32 = np.float64
            opt_mod.np = fake
            whole = ranks.lm_params_from_jax
            ranks.lm_params_from_jax = lambda p, device=None: \
                jax.tree_util.tree_map(
                    lambda t: t.double() if t.is_floating_point() else t,
                    whole(p, device=device))
        arch, over, ssm_over, _ = T.CASES[name]
        r = ranks.train("cpu", None, arch=arch, over=over,
                        ssm_over=ssm_over, params=params, batch=batch,
                        steps=2, lr=T.LR, profile="2d")
        out = {"grads": {k: np.asarray(v, np.float64)
                         for k, v in r["grads"].items()},
               "params": {k: np.asarray(v, np.float64)
                          for k, v in r["params"].items()},
               "losses": [m["loss"] for m in r["metrics"]]}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _strict_misses(got, want, lr):
    """``_check_train``'s strict param rule: (leaf, index, gap, limit) of
    each element over its limit."""
    wg, wp = want["grads"], want["params"]
    top = max(float(np.abs(w).max()) for w in wg.values())
    out = []
    for k, w in wg.items():
        p, q = got["params"][k], wp[k].astype(np.float64)
        noise = (np.abs(w) <= max(1e-5 * np.abs(w).max(), 1e-6 * top)
                 ) & (w != 0)
        lim = np.where(noise, 4 * lr, 1e-4 + 1e-3 * np.abs(q))
        err = np.abs(p - q)
        out += [(k, tuple(int(j) for j in i), float(err[i]), float(lim[i]))
                for i in zip(*np.nonzero(err > lim))]
    return out


def _widened_worst(got, want, lr, wide):
    """The largest gap, in units of ``lr``, over the elements the widened
    rule holds within one step, and the count of elements it fails."""
    wg, wp = want["grads"], want["params"]
    top = max(float(np.abs(w).max()) for w in wg.values())
    worst, fails = 0.0, 0
    for k, w in wg.items():
        q = wp[k].astype(np.float64)
        atol = 1e-4 * float(np.abs(w).max()) + 1e-6 * top
        noise = (np.abs(w) <= max(1e-5 * np.abs(w).max(), 1e-6 * top)
                 ) & (w != 0)
        near = ~noise & (np.abs(w) <= wide * atol)
        lim = np.where(noise, 4 * lr, 1e-4 + 1e-3 * np.abs(q))
        lim = np.where(near, np.maximum(lim, lr), lim)
        err = np.abs(got["params"][k] - q)
        fails += int((err > lim).sum())
        if near.any():
            worst = max(worst, float(err[near].max()) / lr)
    return worst, fails


def main(names):
    sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]
    import test_torch_llm_tp as T
    with tempfile.TemporaryDirectory(prefix="llm_tp_f64_") as tmp:
        for name in names:
            _witness(T, name, tmp)


def _witness(T, name, tmp):
    """Run the four trainings of ``name`` and print the comparison."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    setup = os.path.join(tmp, f"{name}-setup.pkl")
    with open(setup, "wb") as f:
        pickle.dump(T._setup(name), f)
    runs = {}
    for side in ("jax", "torch"):
        for prec in ("f32", "f64"):
            out = os.path.join(tmp, f"{name}-{side}-{prec}.pkl")
            subprocess.run([sys.executable, __file__, "--child", side,
                            prec, name, setup, out], check=True,
                           env=env, cwd=HERE)
            with open(out, "rb") as f:
                runs[f"{side}-{prec}"] = pickle.load(f)
    ref, port = runs["jax-f32"], runs["torch-f32"]
    truth = runs["jax-f64"]
    print(f"== {name}")
    for k, r in runs.items():
        print(f"  losses {k}: {r['losses']}")
    gap = lambda a, b, what: max(float(np.abs(a[what][k] - b[what][k])
                                       .max()) for k in a[what])
    print(f"  float64, port vs reference: first gradients within "
          f"{gap(runs['torch-f64'], truth, 'grads'):.3e}, params after "
          f"two steps within {gap(runs['torch-f64'], truth, 'params'):.3e}")
    seen = set()
    for label, got, want in (("port f32 vs reference f32", port, ref),
                             ("reference f32 vs float64", ref, truth),
                             ("port f32 vs float64", port, truth)):
        misses = _strict_misses(got, want, T.LR)
        print(f"  {label}: {len(misses)} strict-rule misses")
        seen |= {(k, i) for k, i, _, _ in misses}
    for k, i in sorted(seen):
        q = ref["params"][k][i]
        lim = 1e-4 + 1e-3 * abs(q)
        print(f"    {k}{list(i)}: g1 reference {ref['grads'][k][i]:.5e}"
              f" port {port['grads'][k][i]:.5e} float64 "
              f"{truth['grads'][k][i]:.5e} (leaf max "
              f"{np.abs(truth['grads'][k]).max():.3e}); param gap port-"
              f"reference {port['params'][k][i] - q:.3e}, reference-"
              f"float64 {q - truth['params'][k][i]:.3e}, port-float64 "
              f"{port['params'][k][i] - truth['params'][k][i]:.3e}; "
              f"limit {lim:.3e}")
    worst, fails = _widened_worst(port, ref, T.LR, T.VARIANT_WIDE)
    print(f"  widened rule (wide={T.VARIANT_WIDE}), port f32 vs "
          f"reference f32: {fails} misses, worst widened element "
          f"{worst:.3f} LR")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]
        _child(*sys.argv[2:7])
    else:
        main(sys.argv[1:] or VARIANTS)

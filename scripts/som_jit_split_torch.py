"""Where the tiny val step's RaySOM metrics part between the JAX package and
the port (ROADMAP Queue 3): runs, on the CPU, the val step of
tests/test_torch_train_cli.py (`JC.tiny`, weights seeded 8, key 13) three
ways (JAX's jitted `Trainer.val_step`, JAX's `SceneRF.forward` op by op, the
port's `Trainer.val_step` on JAX's draws) and prints RaySOM's metrics of
each; then, for every RaySOM call of JAX's forward (recorded with
`jax.debug.callback`), its outputs in the model's graph against JAX's
`ray_som` alone on the same inputs, and whether each ray where they differ
has a sample whose best prototype is a rounding tie within 4 f32 spacings
of p(z | c2); then the port's RaySOM inputs against JAX's, the assignments
of the two (`som_against_jax`, tie_ulps=4), and the KL rebuilt from each.

    JAX_PLATFORMS=cpu python scripts/som_jit_split_torch.py [--cache DIR]

Needs JAX and the JAX package (it reads tests/_torch_parity.py and
tests/test_torch_train_step.py); `--cache` sets the XLA compilation cache
(default: none, so every program compiles here).
"""
import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cache", default=None, help="XLA compilation cache directory")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.cache:
        jax.config.update("jax_compilation_cache_dir", args.cache)
    import jax.numpy as jnp
    import numpy as np
    import torch

    from _torch_parity import jax_som_p_z_c2, jax_variables, port_model, som_against_jax
    from test_torch_train_step import jax_draws
    from scenerf_tpu import config as JC
    from scenerf_tpu import rendering as JR
    from scenerf_tpu.data.synthetic import make_batch as jax_make_batch
    from scenerf_tpu.model import SceneRF as JaxSceneRF
    from scenerf_tpu.parallel.mesh import make_mesh
    from scenerf_tpu.train import Trainer as JaxTrainer, TrainState
    from scenerf_tpu_torch import config as C
    from scenerf_tpu_torch import rendering as PR
    from scenerf_tpu_torch.data.synthetic import make_batch
    from scenerf_tpu_torch.train import Trainer

    torch.set_num_threads(1)
    jcfg, cfg = JC.tiny(remat_chunks=False, remat_encoder=False), C.tiny()
    jm = JaxSceneRF(jcfg)
    variables = jax_variables(jm, seed=8)
    trainer = JaxTrainer(jcfg, mesh=make_mesh(jax.devices()[:1]), steps_per_epoch=5)
    params = {k: variables[k]["params"] for k in variables}
    state = TrainState.from_variables(variables, trainer.tx.init(params))
    batch = {k: jnp.asarray(v) for k, v in jax_make_batch(jcfg).items()}
    key = jax.random.PRNGKey(13)
    step_key = jax.random.fold_in(jax.random.fold_in(key, 0), 0)

    runs = {"jitted": jax.device_get(trainer.val_step(state, batch, key)),
            "op-by-op": jax.device_get(jm.forward(state.variables(), batch, step_key,
                                                  train=False)[1])}
    port = Trainer(cfg, device="cpu", model=port_model(cfg, variables))
    noise = jax_draws(jcfg, step_key, 1, cfg.n_sources)
    port_inputs = []  # the port's RaySOM inputs, chunk by chunk
    port_som = PR.ray_som

    def port_recording(m, s, sd, alphas, **kw):
        port_inputs.append([t.detach().numpy().copy() for t in (m, s, sd, alphas)])
        return port_som(m, s, sd, alphas, **kw)

    PR.ray_som = port_recording
    try:
        runs["port"] = {k: float(v) for k, v in port.val_step(make_batch(cfg), None,
                                                              noise=noise).items()}
    finally:
        PR.ray_som = port_som
    for k in ("loss_som_kl", "min_som_vars", "total_loss"):
        ref = float(runs["op-by-op"][k])
        print(f"{k}: " + ", ".join(f"{n} {float(r[k]):.8g} "
                                   f"(rel {abs(float(r[k]) - ref) / abs(ref):.2e})"
                                   for n, r in runs.items()))

    # every RaySOM call of JAX's op-by-op forward: its inputs and its outputs
    # in the graph (the model's scan compiles them), and JAX's ray_som on the
    # same inputs alone; the rays whose outputs differ, and whether each has
    # a sample whose best prototype is a tie within 4 f32 spacings of
    # p(z | c2) (the far-sample floor of ROADMAP Queue 3 #1)
    from scenerf_tpu import som as JSOM

    kw = dict(som_sigma=jcfg.som_sigma, mask_threshold=jcfg.som_mask_threshold,
              std_floor=jcfg.kl_std_floor)
    rec = []
    ray_som = JR.ray_som

    def recording(m, s, sd, alphas, **kw_):
        out = ray_som(m, s, sd, alphas, **kw_)
        jax.debug.callback(lambda *a: rec.append([np.asarray(x) for x in a]), m, s, sd, alphas,
                           out.loss_kl, out.new_means, out.new_vars, ordered=True)
        return out

    JR.ray_som = recording
    try:
        in_graph = jax.device_get(jm.forward(state.variables(), batch, step_key,
                                             train=False)[1])
    finally:
        JR.ray_som = ray_som
    print(f"op-by-op with the recording callback: loss_som_kl "
          f"{float(in_graph['loss_som_kl']):.8g}")
    n_off = n_off_tie = n_tie = 0
    for i, (m, s, d, a, kl, nm, nv) in enumerate(rec):
        alone = JSOM.ray_som(*map(jnp.asarray, (m, s, d, a)), **kw)
        off = ((np.abs(np.asarray(alone.new_means) - nm) > 1e-3).any(1)
               | (np.abs(np.asarray(alone.new_vars) - nv) > 1e-3 * np.abs(nv).max()).any(1))
        p = jax_som_p_z_c2(m, s, d, a, jcfg.som_sigma)
        top2 = np.sort(p, axis=2)[..., -2:]
        tie = ((top2[..., 1] - top2[..., 0]) <= 4 * np.spacing(top2[..., 1])).any(1)
        n_off, n_off_tie = n_off + off.sum(), n_off_tie + (off & tie).sum()
        n_tie += tie.sum()
        print(f"chunk {i} ({len(m)} rays): KL mean in the graph {kl.mean():.6g}, alone "
              f"{np.asarray(alone.loss_kl).mean():.6g}; rays whose new means or variances "
              f"differ {int(off.sum())}, without a tie sample {int((off & ~tie).sum())}")
        for r in np.flatnonzero(off & ~tie)[:1]:
            print(f"  a ray that differs without a tie: chunk {i}, ray {r}")
    print(f"in the graph vs alone: {int(n_off)} rays differ, {int(n_off_tie)} of them with a "
          f"tie sample (rays with a tie sample: {int(n_tie)} of {32 * len(rec)})")
    # the per-chunk record in order: a source's training chunks, then its GT-depth chunk
    rec = {"op-by-op": [r_[:4] for r_ in rec]}

    # the port's inputs against JAX's (op by op): JAX renders a source's
    # training chunks then its GT-depth chunk (RaySOM runs on every JAX
    # render), the port RaySOMs its training chunks only
    per_src = len(rec["op-by-op"]) // cfg.n_sources
    jax_train = [c for i, c in enumerate(rec["op-by-op"]) if i % per_src < per_src - 1]
    jt = [np.concatenate(x) for x in zip(*jax_train)]
    pt = [np.concatenate(x) for x in zip(*port_inputs)]
    for i, name in enumerate(("g_means", "g_stds", "sorted distances", "alphas")):
        print(f"{name} {pt[i].shape}: port vs JAX, largest difference relative to the "
              f"largest value "
              f"{float(np.abs(pt[i] - jt[i]).max() / max(np.abs(jt[i]).max(), 1e-30)):.2e}")
    pp, pj2 = jax_som_p_z_c2(*pt, jcfg.som_sigma), jax_som_p_z_c2(*jt, jcfg.som_sigma)
    bp, bj2 = pp.argmax(2), pj2.argmax(2)
    differ = bp != bj2
    best_p = np.take_along_axis(pj2, bj2[..., None], 2)[..., 0]
    other_p = np.take_along_axis(pj2, bp[..., None], 2)[..., 0]
    gap = np.abs(best_p - other_p) / np.spacing(best_p)
    floor = pj2.max(2) <= 1.0e-4  # every likelihood at the 1e-5 floor (x density)
    rays = differ.any(1)
    print(f"best prototype, the port's inputs vs JAX's: {int(differ.sum())} of {differ.size} "
          f"samples, {int(rays.sum())} of {differ.shape[0]} rays differ; of those samples "
          f"{int((differ & (gap <= 4)).sum())} tie within 4 f32 spacings of JAX's p(z | c2), "
          f"{int((differ & floor).sum())} at the likelihood floor; the largest gap "
          f"{float(gap[differ].max(initial=0)):.3g} spacings")
    # RaySOM's loss_som_kl rebuilt from each run's recorded chunks: the sum
    # over sources of the mean KL of the source's training rays
    for name, chunks in (("JAX's chunks", jax_train), ("the port's chunks", port_inputs)):
        kl = np.concatenate([np.asarray(JSOM.ray_som(*map(jnp.asarray, c), **kw).loss_kl)
                             for c in chunks])
        per = kl.reshape(cfg.n_sources, -1).mean(1)
        print(f"loss_som_kl from JAX's ray_som on {name}: {float(per.sum()):.8g} "
              f"(per source {per})")
    if (differ & (gap > 4)).any():
        r, q = np.argwhere(differ & (gap > 4))[0]
        print(f"first sample beyond 4 spacings: ray {r}, sample {q}: JAX's p(z | c2) "
              f"{pj2[r, q]} (best {bj2[r, q]}), the port's inputs' {pp[r, q]} (best {bp[r, q]})")


if __name__ == "__main__":
    main()

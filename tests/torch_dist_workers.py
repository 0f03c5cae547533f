"""Rank functions of the tests of the port's data mesh (tests/test_torch_mesh.py,
test_torch_sharded_*.py, test_torch_multidevice_cli.py).

parallel/launch.run spawns them in fresh processes, which import them by
this module's path: the module imports no JAX and nothing that does. Each
takes the rank's mesh first and returns what rank 0 hands back to the test.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from tpu_reid_torch.parallel import launch
from tpu_reid_torch.parallel import mesh as PM

launch_run = launch.run


def spawn(fn, *args, devices=2, **kw):
    """launch.run of `fn` over `devices` gloo ranks with one intra-op
    thread each, bounded."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks split this process's threads
    try:
        return launch.run(fn, args, devices=devices, device="cpu", timeout_s=120,
                          join_timeout_s=600, **kw)
    finally:
        torch.set_num_threads(threads)


def same_on_every_rank(mesh, tree) -> bool:
    """True when every tensor leaf of `tree` is bit-equal on every rank."""
    ok = True
    for t in PM._leaves(tree):
        every = PM.all_gather_rows(mesh, t.detach().reshape(1, -1))
        ok = ok and all(torch.equal(every[0], every[i]) for i in range(1, mesh.size))
    return ok


# ---------------------------------------------------------------------------
# parallel/mesh.py and parallel/launch.py
# ---------------------------------------------------------------------------


def toy_loss(theta, x_local, w, mesh=None):
    """A per-row "encoder" x * theta on this rank's rows, gathered, then a
    global loss with a direct path in theta too."""
    f = x_local * theta
    if mesh is not None:
        f = PM.gather_rows(mesh, f)
    return (f * w).sum() + (theta ** 3).sum()


def mesh_checks(mesh, x, w, theta0):
    out = {"rank_shape": (mesh.rank, mesh.size, dict(mesh.shape))}
    theta = torch.tensor(theta0, requires_grad=True)
    loss = toy_loss(theta, torch.from_numpy(PM.shard_batch(mesh, x)), torch.from_numpy(w),
                    mesh)
    loss.backward()
    PM.all_reduce_grads(mesh, [theta])
    out["loss"], out["grad"] = float(loss), theta.grad.clone()
    out["grad_same"] = same_on_every_rank(mesh, theta.grad)
    out["bytes"] = {dt: PM.all_gather_rows(mesh, (torch.arange(4) + 10 * mesh.rank).to(dt))
                    for dt in (torch.bool, torch.bfloat16, torch.float8_e4m3fn, torch.int64)}
    t = torch.full((3,), float(mesh.rank))
    PM.replicate(mesh, {"t": t})
    out["replicated"] = t.clone()
    PM.check_replicated(mesh, {"a": torch.ones(3), "b": [torch.arange(2.0)]}, "equal leaves")
    try:
        PM.check_replicated(mesh, {"a": torch.ones(3) * mesh.rank}, "the rank's own leaves")
    except RuntimeError as e:
        out["check_replicated"] = str(e)
    out["agree_same"] = PM.agree(mesh, True, "a flag")
    try:
        PM.agree(mesh, mesh.rank == 0, "a flag")
    except RuntimeError as e:
        out["agree"] = str(e)
    return out


def fail_on_rank1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    PM.agree(mesh, True, "a flag")  # rank 0 waits for the failed rank


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------


def zero_shot_extractor(sd, mesh, device="cpu"):
    """(params, fp32 extractor over a make_zeroshot_embed of the converted
    state dict), at 32x16, stride 8, with flip-TTA and the folded norm."""
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models.vit import fold_visual_input_norm
    from tpu_reid_torch.parallel.extract import make_extractor
    from tpu_reid_torch.pipelines import zero_shot as Z
    from tpu_reid_torch.weights.convert import convert_clip

    cfg, params = convert_clip(sd, image_hw=(32, 16), stride=8, device=device)
    fold = lambda p: dict(p, visual=fold_visual_input_norm(p["visual"], "vit"))  # noqa: E731
    ext = make_extractor(Z.make_zeroshot_embed(params, cfg),
                         DevicePreprocess((32, 16), "vit", dtype=torch.float32),
                         flip_tta=True, dtype=torch.float32, fold=fold, device=device,
                         mesh=mesh)
    return params, ext


def host_batches(images, valid):
    """Loader-style batches (.images, .pids, .camids, .seqids, .valid) of
    stacked (n, B, H, W, 3) images and (n, B) valid masks."""
    out = []
    for k, (im, v) in enumerate(zip(images, valid)):
        ids = np.arange(len(v)) + 100 * k
        out.append(SimpleNamespace(images=im, pids=ids, camids=ids % 3, seqids=ids % 2,
                                   valid=v))
    return out


def sharded_extraction(mesh, sd, images, valid):
    from tpu_reid_torch.parallel.extract import extract_embeddings

    params, ext = zero_shot_extractor(sd, mesh)
    feats, pids, camids, _ = extract_embeddings(ext, params, host_batches(images, valid),
                                                device="cpu", mesh=mesh)
    return {"feats": feats, "pids": pids, "camids": camids,
            "same": same_on_every_rank(mesh, feats)}


def multihost_extraction(mesh, sd, records, out_dir):
    """extract_embeddings_multihost over `records` at a global batch of 4;
    every rank writes what it got to out_dir/rank<r>.pt."""
    from tpu_reid_torch.parallel.multihost import extract_embeddings_multihost

    params, ext = zero_shot_extractor(sd, mesh)
    out = extract_embeddings_multihost(ext, params, records, 4, (32, 16), mesh)
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    return out


def as_host(fn, addr, host_id, num_hosts, *args):
    """One "host" of a multi-host world on this machine: its one rank
    joins at `addr` (parallel/launch.run with devices=1)."""
    torch.set_num_threads(1)
    return launch.run(fn, args, devices=1, device="cpu", multihost=addr, num_hosts=num_hosts,
                      host_id=host_id, timeout_s=120)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def rank_batches(mesh, batches):
    """Global (images, labels, valid) batches as a rank's: its rows of the
    images, the global labels and mask."""
    return [(PM.shard_batch(mesh, im), lab, v) for im, lab, v in batches]


def sharded_training(mesh, models, batches, nan_batches, mt_models, mt_epochs, records, sels):
    from tpu_reid_torch.data.device_cache import DeviceImageCache
    from tpu_reid_torch.runtime.guard import TrainGuard
    from tpu_reid_torch.train import multitask as TMT
    from tpu_reid_torch.train import trainer as TTR

    out = {}
    cfg_t = TTR.TrainConfig()
    for mode, (tcfg, tp) in models.items():
        mine = rank_batches(mesh, batches)
        s1 = TTR.run_stage1(tp, tcfg, cfg_t, lambda e: iter(mine), epochs=2, batch_size=8,
                            log=lambda s: None, mesh=mesh)
        out[f"stage1_{mode}"] = (s1, same_on_every_rank(mesh, s1))
        if mode == "ivlp":
            s2 = TTR.run_stage2(tp, tcfg, cfg_t, lambda e: iter(mine), epochs=2,
                                log=lambda s: None, mesh=mesh)
            out["stage2_ivlp"] = (s2, same_on_every_rank(mesh, s2))
            guard = TrainGuard(snapshot_every=1, max_restores=3, log=lambda s: None)
            bad = rank_batches(mesh, nan_batches)
            s2g = TTR.run_stage2(tp, tcfg, cfg_t, lambda e: iter(bad), epochs=1,
                                 log=lambda s: None, guard=guard, mesh=mesh)
            restores = PM.all_gather_rows(mesh, torch.tensor([guard.restores]))
            out["guard"] = (s2g, same_on_every_rank(mesh, s2g), restores.tolist(),
                            [e["step"] for e in guard.events])
    cache = DeviceImageCache(records, (32, 16), mesh=mesh)
    rows = {name: PM.all_gather_rows(mesh, cache.gather(sel)) for name, sel in sels.items()}
    out["cache"] = (rows, cache.n_local, cache.nbytes())
    mt_cfg, mt_tp = mt_models
    for stage, run in ((1, TMT.run_mt_stage1), (2, TMT.run_mt_stage2)):
        eps = {e: [(t, (PM.shard_batch(mesh, im), lab, v)) for t, (im, lab, v) in b]
               for e, b in mt_epochs[stage].items()}
        kw = dict(xbm_capacity=16, xbm_start_epoch=0) if stage == 2 else {}
        mt = run(mt_tp, mt_cfg, cfg_t, lambda e: iter(eps[e]), epochs=1, log=lambda s: None,
                 mesh=mesh, **kw)
        out[f"mt_stage{stage}"] = (mt, same_on_every_rank(mesh, mt))
    return out


# ---------------------------------------------------------------------------
# re-ranking
# ---------------------------------------------------------------------------


def sharded_rerank(mesh, workloads, kw):
    from tpu_reid_torch.retrieval import metrics as TM
    from tpu_reid_torch.retrieval import rerank_stream as TS

    out = []
    for qf, gf, qp, gp in workloads:
        q, g = torch.from_numpy(qf), torch.from_numpy(gf)
        t, rowmax, a_sum, b_sum = TS._streamed_core_sharded(
            q, g, mesh, kw["k1"], kw["k2"], kw["row_block"], 1024, 1024, 2048, torch.float32,
            torch.float32)
        cols = PM.all_gather_rows(mesh, t.T.contiguous()).T  # every rank's gallery columns
        dist = TS.k_reciprocal_rerank_streamed(q, g, mesh=mesh, **kw)
        dist8 = TS.k_reciprocal_rerank_streamed(q, g, mesh=mesh, k1=kw["k1"], k2=kw["k2"],
                                                row_block=kw["row_block"])
        # the row provider at a chunk of 5 rows, well under a rank's share
        row_fn, q_chunk = TS.k_reciprocal_rerank_streamed_rows(
            q, g, mesh=mesh, q_chunk=5, k1=kw["k1"], k2=kw["k2"], row_block=kw["row_block"])
        rows = torch.cat([row_fn(s) for s in range(0, len(qf), q_chunk)])[:len(qf)]
        ev = TM.Evaluator(len(qp), max_rank=5, reranking=True, rerank_params=(kw["k1"], kw["k2"],
                                                                              0.3),
                          rerank_mode="streamed", mesh=mesh, with_minp=True)
        ev.update(torch.cat([q, g]), np.concatenate([qp, gp]), np.concatenate([qp, gp]) % 3)
        out.append({"t": cols, "rowmax": rowmax, "a_sum": a_sum, "b_sum": b_sum, "dist": dist,
                    "dist8": dist8, "rows": rows, "q_chunk": q_chunk, "metrics": ev.compute(),
                    "same": same_on_every_rank(mesh, dist8)})
    return out


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def cli_mains(mesh, runs):
    """Each (module, argv, fp32) of `runs` in turn through the CLI's main,
    inside this world: main parses and checks the flags as always, and its
    launch.run hands the rank body this mesh (argv's --devices and --tp
    must be the mesh's shape) where it would spawn a new world. fp32: extraction in
    fp32 (the CLI parity tests' setting). Returns the results in order."""
    import importlib

    def into_this_world(fn, args, devices, multihost=None, tp=1, **_):
        if devices != mesh.size or tp != mesh.model_size or multihost:
            raise ValueError(f"--devices {devices} --tp {tp} in a world of {mesh.shape}")
        return fn(mesh, *args)

    out = []
    for module, argv, fp32 in runs:
        cli = importlib.import_module(module)
        dtype = cli.EXTRACT_DTYPE
        launch.run = into_this_world
        try:
            if fp32:
                cli.EXTRACT_DTYPE = torch.float32
            out.append(cli.main(argv))
        finally:
            launch.run, cli.EXTRACT_DTYPE = launch_run, dtype
    return out


def cli_host(module, argv, out_path):
    """One host of a multi-host CLI run: main(argv) (with --multihost), its
    result written to out_path when this host returns one."""
    import importlib

    torch.set_num_threads(1)
    res = importlib.import_module(module).main(argv)
    if res is not None:
        torch.save(res, out_path)


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------


def tp_checks(mesh, visual, cfg, images):
    """On this rank's shard of `visual` and its data rows of `images`:
    apply_vit_tp (whole sequence and cls_only) and make_tp_extractor (fp32,
    flip-TTA), each gathered over the data axis into global batch order;
    every rank's (global rank, data index, model index); whether the ranks
    of each model group got the same features."""
    import torch.distributed as dist

    from tpu_reid_torch.parallel import tp as TP

    shard = TP.shard_tp_visual(TP.tp_visual_layout(visual, cfg.heads), mesh.model_rank,
                               mesh.model_size)
    x = torch.from_numpy(PM.shard_batch(mesh, images))
    reduce = TP.model_reduce(mesh)
    with torch.no_grad():
        full = TP.apply_vit_tp(shard, cfg, x, reduce)
        cls = TP.apply_vit_tp(shard, cfg, x, reduce, cls_only=True)
    feats = TP.make_tp_extractor(mesh, cfg, None, flip_tta=True, dtype=torch.float32)(shard, x)
    every = [torch.empty(1, 3, dtype=torch.int64) for _ in range(dist.get_world_size())]
    dist.all_gather(every, torch.tensor([[dist.get_rank(), mesh.rank, mesh.model_rank]]))
    in_group = [torch.empty_like(feats) for _ in range(mesh.model_size)]
    dist.all_gather(in_group, feats, group=mesh.model_group)
    return {"full": [PM.all_gather_rows(mesh, t) for t in full],
            "cls": [PM.all_gather_rows(mesh, t) for t in cls],
            "extract": PM.all_gather_rows(mesh, feats),
            "indices": torch.cat(every).tolist(),
            "shape": dict(mesh.shape),
            "model_group_same": all(torch.equal(in_group[0], f) for f in in_group)}


def cli_runs_with_features(mesh, runs):
    """Each (module, argv, fp32) of `runs` through cli_mains in turn, with
    the zero-shot pipeline's evaluate_zero_shot wrapped to keep what it was
    handed and what it returned. Per run, rank 0's ("ok", (cmc, mAP),
    {"q", "g": features, "metrics": (cmc, mAP, mINP)}), or ("error",
    "<type>: <message>") for a run that raised (a refusal under test)."""
    from tpu_reid_torch.pipelines import zero_shot as Z

    evaluate = Z.evaluate_zero_shot
    out = []
    for run in runs:
        seen = {}

        def keep(qf, gf, *a, **kw):
            seen["q"], seen["g"] = qf.clone(), gf.clone()
            seen["metrics"] = got = evaluate(qf, gf, *a, **kw)
            return got

        Z.evaluate_zero_shot = keep
        try:
            (res,) = cli_mains(mesh, [run])
            out.append(("ok", res, seen))
        except Exception as e:  # the refusal under test, handed to the parent
            out.append(("error", f"{type(e).__name__}: {e}"))
        finally:
            Z.evaluate_zero_shot = evaluate
    return out

"""One rank of a gloo process group on the CPU, for tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py CASE RANK WORLD DIR

Joins the group on a FileStore in DIR (60 s timeout), runs CASE, which reads
its inputs from DIR/inputs.pt (written by the test) and writes
DIR/CASE_r{RANK}.pt, and leaves the group. A failed check raises, and the
process exits non-zero. Imports neither JAX nor surfd_tpu.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from surfd_tpu_torch import parallel  # noqa: E402
from surfd_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from surfd_tpu_torch.parallel import multihost  # noqa: E402


def case_chunks(inp, rank, world, mesh):
    """QueryStream.run / fetch split over the ranks equal the unsharded
    results bit for bit: float, bool and several-rows-a-point outputs, slice
    counts that split evenly, unevenly and leave a rank without a slice."""
    from surfd_tpu_torch.geometry import QueryStream

    pts = torch.from_numpy(inp["pts"])
    fns = {"norm": lambda p: p.norm(dim=-1), "bool": lambda p: p[:, 0] > 0.1 * p[:, 1],
           "rows": lambda p: (p * 3.0).repeat_interleave(4, 0)[:, :2]}
    for chunk in (256, 300, 4096, 8192):
        one, ranks = QueryStream("cpu", chunk), QueryStream("cpu", chunk, mesh)
        for name, fn in fns.items():
            want, got = one.run(fn, pts), ranks.run(fn, pts)
            assert got.dtype == want.dtype and torch.equal(got, want), (name, chunk)
    got = QueryStream("cpu", 256, mesh).fetch(fns["norm"], inp["pts"])
    assert np.array_equal(got, QueryStream("cpu", 256).fetch(fns["norm"], inp["pts"]))
    empty = QueryStream("cpu", 256, mesh).run(fns["norm"], pts[:0])
    assert empty.shape == (0,)
    return {"norm": got}


def case_async_chunks(inp, rank, world, mesh):
    """QueryStream.start split over the ranks equals the unsharded stream bit
    for bit, on float, bool and int8 outputs; so do the evaluator's int8
    unit gradients by grid id (`grad_i8_gid_async`, the marching query)."""
    from surfd_tpu_torch.geometry import QueryStream

    fns = {"norm": lambda p: p.norm(dim=-1), "bool": lambda p: p[:, 0] > 0.1 * p[:, 1],
           "int8": lambda p: torch.round(p * 100.0).to(torch.int8)}
    out = {}
    for chunk in (256, 300, 8192):
        for name, fn in fns.items():
            want = QueryStream("cpu", chunk).fetch(fn, inp["pts"])
            pending = QueryStream("cpu", chunk, mesh).start(fn, inp["pts"])
            got = pending()
            assert got.dtype == want.dtype and np.array_equal(got, want), (name, chunk)
            out[f"{name}_{chunk}"] = got
    udf = _udf(inp, inp["latent"])
    gids = inp["gids"]
    want = udf.grad_i8_gid_async(gids, 48, -1.0, 2.0 / 47, udf.queries)()
    got = udf.grad_i8_gid_async(gids, 48, -1.0, 2.0 / 47,
                                QueryStream("cpu", udf.chunk, mesh))()
    assert got.dtype == np.int8 and np.array_equal(got, want)
    out["grad_i8"] = got
    return out


def _udf(inp, latent):
    from surfd_tpu_torch.models import CbnDecoder
    from surfd_tpu_torch.pipelines import make_udf_fn

    dec = CbnDecoder(8, 32, 2)
    return make_udf_fn(dec, inp["decoder"], latent, device="cpu", chunk=2**12)


def case_extract(inp, rank, world, mesh):
    """The 48³ extraction of the JAX package's sharded test, at several
    settings, sharded against unsharded: faces equal, vertices within 1e-6;
    then the batch generator at depth 2 on three latents."""
    from surfd_tpu_torch.models import CbnDecoder
    from surfd_tpu_torch.pipelines import (
        MeshExtractionConfig,
        generate_meshes,
        get_mesh_from_udf,
        get_watertight_mesh_from_udf,
    )

    base = MeshExtractionConfig(resolution=48, max_batch=2**12, filter_faces=True,
                                face_filter_mult=8.0)
    out = {}
    settings = {"default": {}, "exact_points": {"quantized_filter_points": False},
                "auto_bias": {"surface_bias": "auto"}}
    for name, kw in settings.items():
        cfg = dataclasses.replace(base, **kw)
        one, stats = get_mesh_from_udf(_udf(inp, inp["latents"][0]), cfg=cfg, return_stats=True)
        dp = get_mesh_from_udf(_udf(inp, inp["latents"][0]),
                               cfg=dataclasses.replace(cfg, mesh=mesh))
        assert len(one.faces) > 100, name
        assert np.array_equal(one.faces, dp.faces), name
        assert float(np.abs(one.vertices - dp.vertices).max()) <= 1e-6, name
        out[f"{name}_faces"] = dp.faces
        out[f"{name}_two_tier"] = bool(stats["ff_two_tier"])
    one = get_watertight_mesh_from_udf(_udf(inp, inp["latents"][0]), cfg=base)
    dp = get_watertight_mesh_from_udf(_udf(inp, inp["latents"][0]),
                                      cfg=dataclasses.replace(base, mesh=mesh))
    assert np.array_equal(one.faces, dp.faces) and np.array_equal(one.vertices, dp.vertices)

    dec = CbnDecoder(8, 32, 2)
    dec.load_state_dict({k[len("decoder."):]: v for k, v in inp["decoder"].items()})
    lats = torch.from_numpy(inp["latents"])
    seq = generate_meshes(dec, lats, base, device="cpu")
    pipe = generate_meshes(dec, lats, dataclasses.replace(base, mesh=mesh), pipelined=True,
                           device="cpu")
    for a, b in zip(seq, pipe, strict=True):
        assert np.array_equal(a.faces, b.faces)
        assert float(np.abs(a.vertices - b.vertices).max()) <= 1e-6
    out["pipelined_faces"] = [m.faces for m in pipe]
    return out


def _mdm(inp, cond_mode):
    from surfd_tpu_torch.models import MDM

    m = MDM(cond_mode=cond_mode, **inp["mdm_kw"])
    m.load_state_dict(inp["init"][cond_mode], strict=True)
    return m


def case_train(inp, rank, world, mesh):
    """Three DDP steps on the global inputs (category, cond dropout), the
    first step's averaged gradients; then two steps in each other cond mode
    (DDP raises at the next step if a parameter got no gradient)."""
    from surfd_tpu_torch.diffusion import named_schedule
    from surfd_tpu_torch.training import create_train_state, make_optimizer, make_train_step

    sched = named_schedule("cosine", 1000)
    tm = _mdm(inp, "category")
    state = create_train_state(tm, make_optimizer(tm.parameters(), inp["lr"]),
                               ema_rate=inp["ema_rate"])
    step = make_train_step(tm, sched, cond_mask_prob=inp["cond_p"], mesh=mesh)
    out = {"metrics": []}
    for k, (batch, t, w, noise, drop) in enumerate(inp["steps"]):
        if k == 0:
            loss, _ = step.loss_fn(batch, t, w, noise=noise, cond_drop=drop)
            loss.backward()
            out["grads"] = {n: p.grad.clone() for n, p in tm.named_parameters()}
            tm.zero_grad(set_to_none=True)
        m = step(state, batch, t, w, noise=noise, cond_drop=drop)
        out["metrics"].append({k_: v for k_, v in m.items()})
    out["params"] = {n: v.clone() for n, v in tm.state_dict().items()}
    out["ema"] = {n: v.clone() for n, v in state.ema_state_dict().items()}
    for mode in ("no_cond", "sketch"):
        tm = _mdm(inp, mode)
        state = create_train_state(tm, make_optimizer(tm.parameters(), inp["lr"]))
        step = make_train_step(tm, sched, cond_mask_prob=inp["cond_p"], mesh=mesh)
        gen = torch.Generator().manual_seed(3)
        for batch, t, w, _, _ in inp["steps"][:2]:
            b = {"latents": batch["latents"]}
            if mode == "sketch":
                b["context"] = np.ones((len(t), 512), np.float32)
            m = step(state, b, t, w, generator=gen)
            assert np.isfinite(float(m["loss"])) and m["nonfinite_skipped"] == 0.0, mode
        out[f"{mode}_params"] = {n: v.clone() for n, v in tm.state_dict().items()}
    return out


def _trainer(inp, mesh, steps, **kw):
    from surfd_tpu_torch.diffusion import named_schedule
    from surfd_tpu_torch.training import (
        DiffusionTrainConfig,
        DiffusionTrainer,
        create_train_state,
        make_optimizer,
    )

    tm = _mdm(inp, "no_cond")
    state = create_train_state(tm, make_optimizer(tm.parameters(), inp["lr"]))
    rng = np.random.default_rng(5)

    def batches():
        while True:
            yield {"latents": (0.5 * rng.normal(size=(4, inp["L"]))).astype(np.float32)}

    cfg = DiffusionTrainConfig(batch_size=4, num_steps=steps, stall_exit_s=0, **kw)
    return DiffusionTrainer, cfg, tm, state, batches(), named_schedule("cosine", 10)


def case_sampler(inp, rank, world, mesh):
    """20 steps with the loss-aware sampler: its history after them (equal on
    every rank: each sees the global batch's losses)."""
    T, cfg, tm, state, data, sched = _trainer(inp, mesh, 20,
                                              schedule_sampler="loss-second-moment")
    trainer = T(cfg, tm, sched, state, data, generator=torch.Generator().manual_seed(2),
                mesh=mesh)
    trainer.run()
    s = trainer.schedule_sampler
    return {"history": s._loss_history.copy(), "counts": s._loss_counts.copy()}


def case_ckpt(inp, rank, world, mesh):
    """Two steps with a checkpoint at step 2 and a logger, each rank given
    its own directory (only rank 0's may be written); then every rank
    restores from rank 0's checkpoint into a model of other weights and takes
    a third step."""
    from surfd_tpu_torch.utils import Checkpointer, Logger

    d = inp["dir"]
    T, cfg, tm, state, data, sched = _trainer(inp, mesh, 2, save_interval=2, log_interval=1)
    ck = Checkpointer(os.path.join(d, f"ckpt_r{rank}"))
    log = Logger(os.path.join(d, f"log_r{rank}"), formats=("jsonl",))
    T(cfg, tm, sched, state, data, generator=torch.Generator().manual_seed(2), mesh=mesh,
      checkpointer=ck, logger=log).run()
    log.close()
    multihost.broadcast_from_main(None)  # rank 0 has written
    T, cfg, tm, state, data, sched = _trainer(inp, mesh, 3)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(float(rank + 1))
    Checkpointer(os.path.join(d, "ckpt_r0")).restore(state)
    assert state.step == 2
    T(cfg, tm, sched, state, data, generator=torch.Generator().manual_seed(2), mesh=mesh).run()
    return {"step": state.step, "params": {n: v.clone() for n, v in tm.state_dict().items()}}


def case_multihost(inp, rank, world, mesh):
    """The helpers of parallel/ at this world size (JAX's two-process DCN test
    and its single-host test), and the mesh's refusals."""
    assert parallel.process_count() == world and parallel.process_index() == rank
    assert parallel.is_main_process() == (rank == 0)
    out = parallel.broadcast_from_main({"w": np.full(3, float(rank), np.float32),
                                        "step": 100 + rank})
    assert np.array_equal(out["w"], np.zeros(3, np.float32)) and out["step"] == 100
    gathered = parallel.all_gather_host(np.array([rank, rank * 10], np.int32))
    assert gathered.tolist() == [[r, r * 10] for r in range(world)]
    gb = parallel.global_batch_from_local(mesh, {"x": np.full((4, 2), float(rank + 1),
                                                              np.float32)})
    assert tuple(gb["x"].shape) == (4 * world, 2)
    assert float(gb["x"].full_tensor().sum()) == 8.0 * sum(range(1, world + 1))
    tree = parallel.shard_batch(mesh, {"x": np.arange(4 * world), "y": torch.arange(2 * world)})
    assert tree["x"].tolist() == list(range(4 * rank, 4 * rank + 4))
    assert tree["y"].tolist() == [2 * rank, 2 * rank + 1]
    rep = parallel.replicate(mesh, {"t": torch.full((2,), float(rank)), "a": np.int64(rank)})
    assert rep["t"].tolist() == [0.0, 0.0] and int(rep["a"]) == 0
    assert [type(p).__name__ for p in parallel.data_sharding(mesh)] == ["Shard", "Replicate"]
    assert [type(p).__name__ for p in parallel.replicated(mesh)] == ["Replicate", "Replicate"]
    for bad in ({"data": world + 1}, {"data": 1, "model": world + 1}):
        try:
            parallel.make_mesh(**bad)
        except ValueError:
            pass
        else:
            raise AssertionError(f"make_mesh({bad}) did not raise")
    if world > 1:
        try:
            parallel.shard_batch(mesh, {"x": np.arange(2 * world + 1)})
        except ValueError:
            pass
        else:
            raise AssertionError("an uneven batch did not raise")
    return {"gathered": gathered}


def case_cli(inp, rank, world, mesh):
    """generate_uncond --data_parallel in the group: rank 0 alone writes."""
    from surfd_tpu_torch.cli.generate_uncond import main

    out = os.path.join(inp["dir"], f"cli_r{rank}")
    main(inp["cli_argv"] + ["--data_parallel", "--output_dir", out])
    return {"wrote": sorted(os.listdir(out)) if os.path.isdir(out) else []}


def case_cli_train(inp, rank, world, mesh):
    """train_diffusion in the group: DDP over both ranks from rank 0's
    latent cache; rank 0 alone writes the run."""
    from surfd_tpu_torch.cli import train_diffusion

    final = train_diffusion.main(inp["argv"])
    return {"model": {n: v.clone() for n, v in final.model.state_dict().items()},
            "step": final.step}


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def main():
    case, rank, world, d = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    if os.environ.get("SURFD_NO_GROUP_FIRST"):  # the no-op initialize of one process
        multihost.initialize(device="cpu")
        assert not torch.distributed.is_initialized() and parallel.process_count() == 1
    multihost.initialize(f"file://{os.path.join(d, 'store')}", world, rank, device="cpu",
                         timeout_s=60)
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    inp["dir"] = d
    mesh = pmesh.make_mesh(data=world, model=1)
    res = CASES[case](inp, rank, world, mesh)
    torch.save(res, os.path.join(d, f"{case}_r{rank}.pt"))
    multihost.shutdown()


if __name__ == "__main__":
    main()

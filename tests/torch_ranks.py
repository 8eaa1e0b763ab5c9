"""Rank bodies of the port's multi-process tests (``tests/test_torch_mesh.py``,
``test_torch_distributed.py``, ``test_torch_map_cli.py``,
``test_torch_stream_mesh.py``), run by
``torch_parity.run_ranks`` on gloo ranks on the CPU. This module imports no
JAX, so a spawned rank starts in the time PyTorch takes to import.

Each body rebuilds the port's inputs from an ``.npz`` that the JAX side
wrote (the same states, samples and every shard's draws) and returns plain
numpy values.
"""
import numpy as np
import torch

torch.set_num_threads(1)


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def mesh_draws(z, me: int, events: int, heuristic: bool):
    """Shard ``me``'s replayed draw sources from the JAX side's arrays:
    the run's (per event the probes, heuristic only, then the cascade
    child: drive, then one (4, rows, side) draw a delivery round), the
    latency's and the fault's (one ``{shape: draw}`` site each)."""
    from repro_torch.draws import ReplayDraws
    items = []
    rounds, off = z[f"rounds{me}"], z[f"roff{me}"]
    for ev in range(events):
        if heuristic:
            items.append(z[f"probes{me}"][ev])
        items.append([z[f"drive{me}"][ev]]
                     + list(rounds[off[ev]:off[ev + 1]]))

    def sites(prefix):
        if f"{prefix}4_{me}" not in z:
            return None
        a, b = z[f"{prefix}4_{me}"], z[f"{prefix}2_{me}"]
        return ReplayDraws([{x.shape: x, y.shape: y} for x, y in zip(a, b)])
    return ReplayDraws(items), sites("lat"), sites("flt")


def mesh_cases(rank, cases, shards):
    """``mesh_case`` for each ``(path, spec)`` of ``cases``, in one set of
    ranks."""
    return [mesh_case(rank, path, spec, shards) for path, spec in cases]


def mesh_case(rank, path, spec, shards):
    """One mesh run of the port on replayed JAX draws; the whole result
    (every rank returns the dense state)."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import afm, events
    from repro_torch.core.placement import mesh
    from repro_torch.faults import FaultPlan
    z = dict(np.load(path))
    cfg = afm.AFMConfig(side=6, dim=3, i_max=spec["i_max"], e_factor=1.0)
    heuristic = spec["search"] == "heuristic"
    e = spec["events"]
    draws, lat, flt = mesh_draws(z, rank, e, heuristic)
    plan = FaultPlan(**spec["faults"]) if spec.get("faults") else None
    ecfg = events.EventConfig(latency=spec["latency"], delay=spec["delay"],
                              engine="event", faults=plan)
    kw = {"p_fn": lambda i, c: 1.0} if spec.get("hot") else {}
    state = state_from_numpy({"w": z["w0"], "c": z["c0"], "far": z["far"],
                              "near": z["near"], "i": 0}, "cpu")
    st, aux, rep = events.run_events(
        state, _t(z["samples"]), draws, cfg, ecfg,
        search=afm.search_heuristic if heuristic else afm.search_exact,
        lat_draws=lat, placement="mesh", shards=shards, fault_draws=flt,
        dead=z.get("dead"), **kw)
    out = {"w": st.w.numpy(), "c": st.c.numpy(), "i": st.i,
           **{f: getattr(aux, f).numpy() for f in aux._fields},
           **{f: getattr(rep, f) for f in rep._fields
              if f not in ("clock", "nevents")},
           "clock": rep.clock.numpy(), "nevents": rep.nevents.numpy(),
           "stats": dict(mesh.stats)}
    return out


def sharded_steps(rank, path, shape):
    """The port's sharded step on replayed JAX draws, each step from JAX's
    input state (re-injected): this rank's dense outputs a step."""
    from repro_torch.core import afm, distributed
    from repro_torch.draws import ReplayDraws
    from repro_torch.sharding import ShardMesh
    z = dict(np.load(path))
    cfg = afm.AFMConfig(side=8, dim=36, batch=int(z["batch"]),
                        i_max=int(z["i_max"]), e_factor=0.5,
                        theta=int(z["theta"]))
    mesh = ShardMesh(shape, ("data", "model"))
    step = distributed.make_sharded_train_step(cfg, mesh)
    didx = distributed.data_index(mesh)
    me = mesh.axis_index("model")
    b = cfg.batch // shape[0]
    out = []
    for s in range(int(z["steps"])):
        dense = afm.AFMState(_t(z[f"w_in{s}"]), _t(z[f"c_in{s}"]),
                             _t(z["far"]), _t(z["near"]), int(z[f"i_in{s}"]))
        state = distributed.shard_state_for_mesh(dense, cfg, mesh)
        samples = _t(z[f"samples{s}"])[didx * b:(didx + 1) * b]
        waves = int(z[f"waves{s}"])
        casc = ReplayDraws([z[f"drive{s}_{me}"]]
                           + list(z[f"wave{s}_{me}"][:waves]))
        new, aux = step(state, samples,
                        ReplayDraws([z[f"probes{s}_{didx}_{me}"]]), casc)
        full = distributed.gather_state(new, cfg, mesh)
        out.append({"w": full.w.numpy(), "c": full.c.numpy(), "i": full.i,
                    "size": int(aux.cascade_size), "waves": int(aux.waves),
                    "mean_q2": float(aux.mean_q2), "left": len(casc)})
    return out


def collectives(rank):
    """``ShardMesh``'s collectives on a 2 x 2 mesh and its sub-groups."""
    from repro_torch.sharding import ShardMesh
    m = ShardMesh((2, 2), ("data", "model"))
    x = torch.tensor([-0.0, float(rank), float("nan"), 1e-45])
    return {
        "coords": m.coords,
        "gather_model": m.all_gather(x, "model").view(torch.int32).numpy(),
        "gather_bool": m.all_gather(torch.tensor([rank % 2 == 0]),
                                    "data").numpy(),
        "psum_data": m.psum(torch.tensor([rank, 1]), "data").numpy(),
        "pmax_model": m.pmax(torch.tensor([float(rank)]), "model").numpy(),
        "ppermute": m.ppermute(torch.tensor([rank + 10]), "model",
                               [(0, 1)]).numpy(),
        "calls": m.calls}


def host_mesh(rank):
    """``launch.mesh.make_host_mesh(1, 2)`` over the ranks' group."""
    from repro_torch.launch import mesh as mesh_lib
    m = mesh_lib.make_host_mesh(1, 2)
    return {"shape": m.shape, "coords": m.coords,
            "data_axes": mesh_lib.data_axes(m),
            "psum": m.psum(torch.tensor([0.5, rank + 0.5]), "model").tolist()}


def async_mesh_fit(rank, faults):
    """``TopoMap(backend="async", placement="mesh")`` from one seed on every
    rank, twice, and a run with a fault plan: results and reports."""
    from repro_torch.api import TopoMap
    from repro_torch.core import afm
    x = np.random.default_rng(5).random((256, 3), dtype=np.float32)
    cfg = afm.AFMConfig(side=6, dim=3, i_max=192, e_factor=1.0, theta=2)
    out = []
    for opts in ({}, {}, {"latency": "constant", "delay": 0.5,
                          "faults": faults}):
        tm = TopoMap(cfg, backend="async", device="cpu", seed=3,
                     backend_options={"placement": "mesh", "shards": 2,
                                      "search": "exact", **opts}).fit(x)
        rep = tm.backend.last_report
        out.append({"w": tm.state_.w.numpy(), "qe": tm.quantization_error(x),
                    "rows": rep.shard_counts, "sent": rep.sent,
                    "deliveries": rep.deliveries,
                    "dropped_fault": rep.dropped_fault,
                    "stranded": rep.stranded,
                    "overflow": rep.dropped_overflow})
    return out


def train_map_cli(rank, argv):
    """``repro_torch.launch.train_map.main`` on every rank of the group."""
    from repro_torch.launch import train_map
    tm = train_map.main(argv)
    return {"w": tm.state_.w.numpy(), "backend": tm.backend.name}


# ------------------------------------------ the train-and-serve loop's mesh


#: ``tests/test_torch_stream_mesh.py``'s map and stream: 96 events in
#: chunks of 24 (the warm start is step 0), a publication every 48; a hot
#: cascade schedule (c_m 4, c_d 1), so that every chunk after the warm
#: start cascades across the shard boundary (the defaults fire nothing in
#: 96 events at side 4)
STREAM_MESH = dict(side=4, dim=3, i_max=96, e_factor=0.5, c_m=4.0, c_d=1.0)
STREAM_RUN = dict(events=96, chunk=24, swap_every=48, name="m", seed=7)


class ShardSteps:
    """One step's draw source as the async backend asks a mesh for it:
    ``spawn().fold_in(shard)`` is that shard's replayed draws."""

    def __init__(self, by_shard):
        self.device = torch.device("cpu")
        self._by_shard = by_shard

    def spawn(self):
        return self

    def fold_in(self, shard):
        return self._by_shard[shard]


def stream_step_draws(z, step: int, shards: int, heuristic: bool):
    """``ShardSteps`` of step ``step`` from the JAX side's arrays, which
    hold each step's per-shard draws under the prefix ``s<step>_``, as
    ``mesh_draws`` reads one run's."""
    prefix = f"s{step}_"
    zs = {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}
    events = len(zs["roff0"]) - 1
    return ShardSteps([mesh_draws(zs, me, events, heuristic)[0]
                       for me in range(shards)])


def _artifact(root):
    from repro_torch.api import MapStore
    art = MapStore(root).load_artifact("m", device="cpu")
    return {"w": art.state.w.numpy(), "c": art.state.c.numpy(),
            "i": art.state.i}


def stream_mesh_parity(rank, cases, shards):
    """``run_stream`` on the mesh, store backed, on the JAX side's initial
    state and per-step per-shard draws, for each ``(path, search, root)``
    of ``cases``: rank 0's final artifact and every rank's dense state."""
    from repro_torch.api import AFMConfig
    from repro_torch.convert import state_from_numpy
    from repro_torch.launch.stream_train import run_stream
    from repro_torch.training.async_trainer import AsyncBackend
    out = []
    init = AsyncBackend.init
    try:
        for path, search, root in cases:
            z = dict(np.load(path))
            state = state_from_numpy({"w": z["w0"], "c": z["c0"],
                                      "far": z["far"], "near": z["near"],
                                      "i": 0}, "cpu")
            AsyncBackend.init = lambda self, draws, samples=None: state
            heuristic = search == "heuristic"
            rep = run_stream(
                AFMConfig(**STREAM_MESH), z["xtr"], z["xte"],
                backend="async", store_root=root, clients=0,
                min_client_reads=0, device="cpu",
                backend_options={"placement": "mesh", "shards": shards,
                                 "search": search},
                draws_for_step=lambda step: stream_step_draws(
                    z, step, shards, heuristic), **STREAM_RUN)
            out.append({"w": rep.state.w.numpy(), "c": rep.state.c.numpy(),
                        "events": rep.events, "qe": rep.qe,
                        "art": _artifact(root) if rank == 0 else None})
    finally:
        AsyncBackend.init = init
    return out


def stream_mesh_resume(rank, root, latencies):
    """The port's mesh stream on 2 ranks, store backed: uninterrupted,
    then killed by ``die_after`` at half the events and resumed, at each
    of ``latencies``; then in memory at zero latency with a reader on
    rank 0. Every rank's reports; rank 0's final artifacts."""
    from repro_torch.api import AFMConfig
    from repro_torch.launch.stream_train import run_stream
    rng = np.random.default_rng(0)
    xtr = rng.normal(size=(120, 3)).astype(np.float32)
    xte = rng.normal(size=(32, 3)).astype(np.float32)
    cfg = AFMConfig(**STREAM_MESH)

    def report(rep):
        return {"events": rep.events, "swaps": rep.swaps,
                "seconds": rep.seconds, "interrupted": rep.interrupted,
                "reads": rep.client_requests, "errors": len(rep.client_errors),
                "qe": rep.qe, "w": rep.state.w.numpy(),
                "dispatches": rep.gateway.dispatches}

    out = {}
    for latency in latencies:
        opts = {"placement": "mesh", "shards": 2, "search": "exact",
                "latency": latency,
                "delay": 0.0 if latency == "zero" else 1.0}
        common = dict(backend="async", backend_options=opts, clients=0,
                      min_client_reads=0, device="cpu", **STREAM_RUN)
        a, b, ck = (f"{root}/{latency}-{x}" for x in ("a", "b", "ck"))
        full = run_stream(cfg, xtr, xte, store_root=a, **common)
        cut = run_stream(cfg, xtr, xte, store_root=b, checkpoint_dir=ck,
                         checkpoint_every=24, die_after=48, **common)
        logs = []
        res = run_stream(cfg, xtr, xte, store_root=b, checkpoint_dir=ck,
                         resume=True, log=logs.append, **common)
        out[latency] = {
            "full": report(full), "cut": report(cut), "res": report(res),
            "verified": any("checksum verified" in x for x in logs),
            "arts": [_artifact(a), _artifact(b)] if rank == 0 else None}
    mem = run_stream(cfg, xtr, xte, backend="async", clients=1,
                     client_batch=4, device="cpu",
                     backend_options={"placement": "mesh", "shards": 2,
                                      "search": "exact"}, **STREAM_RUN)
    out["memory"] = report(mem)
    return out


def stream_mesh_cli(rank, root):
    """``repro_torch.launch.stream_train.main`` with ``--shards 2`` on every
    rank: uninterrupted, killed by ``--die-after`` and resumed, each store
    backed. Every rank's event count and whether it was interrupted."""
    import contextlib
    import io
    from repro_torch.launch import stream_train
    base = ["--device", "cpu", "--dist-backend", "gloo", "--dataset",
            "satimage", "--side", "4", "--shards", "2", "--search", "exact",
            "--events", "96", "--chunk", "24", "--swap-every", "48",
            "--clients", "1", "--train-size", "200", "--eval-size", "32",
            "--name", "m"]
    ck = ["--checkpoint-dir", f"{root}/ck"]
    out = []
    for extra in (["--store", f"{root}/a"],
                  ["--store", f"{root}/b", *ck, "--die-after", "48"],
                  ["--store", f"{root}/b", *ck, "--resume"]):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rep = stream_train.main(base + extra)
        out.append({"events": rep.events, "interrupted": rep.interrupted,
                    "reads": rep.client_requests, "stdout": text.getvalue()})
    if rank == 0:
        out.append({"arts": [_artifact(f"{root}/a"), _artifact(f"{root}/b")]})
    return out


# ------------------------------------------------ on the card (gpu marker)


class HostDraws:
    """Draws made on the CPU by a seeded generator and moved to
    ``device``, so a run on the card and one on the CPU consume the very
    same numbers; ``spawn`` and ``fold_in`` seed new sources from this
    one's seed."""

    def __init__(self, seed, device):
        self.device = torch.device(device)
        self.seed, self.spawned = seed, 0
        self.gen = torch.Generator().manual_seed(seed)

    def randint(self, low, high, shape):
        return torch.randint(low, high, tuple(shape),
                             generator=self.gen).to(self.device)

    def uniform(self, shape):
        return torch.rand(tuple(shape), generator=self.gen).to(self.device)

    def exponential(self, shape):
        return -torch.log1p(-self.uniform(shape))

    def spawn(self):
        self.spawned += 1
        return HostDraws(self.seed * 7919 + self.spawned, self.device)

    def fold_in(self, data):
        return HostDraws(self.seed * 1_000_003 + 104_729 * (data + 1),
                         self.device)


def cuda_collectives(rank):
    """``ShardMesh``'s gloo collectives on CUDA tensors (the all_reduce of
    one slot a rank)."""
    from repro_torch.sharding import ShardMesh
    m = ShardMesh((2,), ("shards",))
    x = torch.tensor([-0.0, float("nan"), 1e-45, float(rank)],
                     device="cuda")
    g = m.all_gather(x, "shards")
    return {"bits": g.view(torch.int32).cpu().numpy(),
            "device": str(g.device),
            "psum": m.psum(torch.tensor([rank + 1.5], device="cuda"),
                           "shards").cpu().numpy()}


def mesh_card_and_cpu(rank, latency):
    """A small mesh run on the card and on the CPU from the same host
    draws (exponential delays and a broadcast loss included)."""
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.core import afm, events
    from repro_torch.faults import FaultPlan
    cfg = afm.AFMConfig(side=8, dim=16, theta=3, i_max=96, e_factor=0.5)
    data = torch.randn(64, 16, generator=torch.Generator().manual_seed(4))
    base = state_to_numpy(afm.init(HostDraws(1, "cpu"), cfg, data))
    ecfg = events.EventConfig(latency=latency, delay=1.0,
                              faults=FaultPlan(seed=11, p_loss=0.3))
    out = []
    for dev in ("cuda", "cpu"):
        st, aux, rep = events.run_events(
            state_from_numpy(base, dev), data.to(dev),
            HostDraws(2, dev).fold_in(rank), cfg, ecfg,
            search=afm.search_heuristic, p_fn=lambda i, c: 0.8,
            lat_draws=HostDraws(3, dev).fold_in(rank),
            fault_draws=HostDraws(5, dev).fold_in(rank), placement="mesh",
            shards=2)
        out.append({"w": st.w.cpu().numpy(), "c": st.c.cpu().numpy(),
                    "gmu": aux.gmu.cpu().numpy(),
                    "sizes": aux.cascade_size.cpu().numpy(),
                    "clock": rep.clock.cpu().numpy(),
                    "rows": rep.shard_counts, "rounds": rep.rounds,
                    "deliveries": rep.deliveries})
    return out


def sharded_card_and_cpu(rank):
    """One sharded step on a (1, 2) mesh on the card and on the CPU from
    one state and the same host draws."""
    from repro_torch.core import afm, distributed
    from repro_torch.sharding import ShardMesh
    cfg = afm.AFMConfig(side=8, dim=36, batch=8, theta=2, i_max=320,
                        e_factor=0.5)
    mesh = ShardMesh((1, 2), ("data", "model"))
    step = distributed.make_sharded_train_step(cfg, mesh)
    data = torch.rand(64, 36, generator=torch.Generator().manual_seed(6))
    dense = afm.init(HostDraws(1, "cpu"), cfg, data)
    out = []
    for dev in ("cuda", "cpu"):
        src = HostDraws(9, dev)
        moved = afm.AFMState(dense.w.to(dev), dense.c.to(dev),
                             dense.far.to(dev), dense.near.to(dev), 0)
        new, aux = step(distributed.shard_state_for_mesh(moved, cfg, mesh),
                        data[:8].to(dev), src.fold_in(0).fold_in(rank),
                        src.fold_in(distributed.CASCADE_FOLD).fold_in(rank))
        full = distributed.gather_state(new, cfg, mesh)
        out.append({"w": full.w.cpu().numpy(), "c": full.c.cpu().numpy(),
                    "size": int(aux.cascade_size), "waves": int(aux.waves)})
    return out


def moe_ep(rank, cases, factors):
    """``test_torch_moe_train.py``'s expert parallelism on a 2-rank
    ``model`` axis: for each smoke config in ``cases`` (JAX's layer-0 MoE
    weights, the tokens and JAX's routing as arrays) and each capacity
    factor, ``moe_ep_path`` on this rank's half of the experts fed JAX's
    routing, and ``moe(..., mesh=)`` with its own; numpy results."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import mlp
    from repro_torch.sharding import ShardMesh
    mesh = ShardMesh((2,), ("model",))
    out = {}
    for arch, a in cases.items():
        base = configs.get_smoke(arch)
        p = mlp.MoE(base, "cpu")
        with torch.no_grad():
            for name in ("router", "wg", "wu", "wd"):
                getattr(p, name).copy_(_t(a[name]))
            if p.shared is not None:
                for name in ("wg", "wu", "wd"):
                    getattr(p.shared, name).copy_(_t(a[f"shared_{name}"]))
        x = _t(a["x"])
        e_loc = base.num_experts // 2
        local = {n: getattr(p, n)[rank * e_loc:(rank + 1) * e_loc]
                 for n in ("wg", "wu", "wd")}
        out[arch] = []
        for f in factors:
            body = mlp.moe_ep_path(local, x, _t(a["top_i"]).long(),
                                   _t(a["top_p"]), base, torch.float32, mesh,
                                   capacity_factor=f)
            cfg = dataclasses.replace(base, moe_impl="ep",
                                      moe_capacity_factor=f)
            y, aux = mlp.moe(p, x[None], cfg, mesh=mesh)
            out[arch].append({"body": body.numpy(), "moe": y[0].numpy(),
                              "aux": float(aux)})
    return out


def _dtensor_batch(batch, specs, mesh):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.sharding import rules
    return {k: distribute_tensor(v, mesh, rules.placements(specs[k], mesh))
            for k, v in batch.items()}


def _full(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def dtensor_routing(rank, cases):
    """The model code's DTensor routing with real values: for each (arch,
    moe_impl) of ``cases``, its smoke config (f32, seed 0) on a 2 x 2
    (data, model) ``DeviceMesh`` of the gloo ranks, every parameter, batch
    and cache leaf distributed with its spec's placements, against the
    same model on plain tensors: the loss and every gradient of a train
    step's loss, a prefill's last logits and cache, and three greedy
    decode steps' logits. Returns each case's largest differences, each
    over the largest magnitude of its reference."""
    import copy
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.sharding import rules
    from repro_torch.training.train_step import lm_loss
    from repro_torch.sharding.compat import DeviceMeshAxes
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    axes = DeviceMeshAxes(mesh)
    out = {"axes": {
        "index": [axes.axis_index("data"), axes.axis_index("model")],
        "psum": axes.psum(torch.tensor([float(rank)]), "model").tolist(),
        "gather": axes.all_gather(torch.tensor([rank, 10 * rank]),
                                  "data").tolist()}}
    b, s, new, cache_len = 4, 16, 3, 24

    def rel(a, ref):
        a, ref = _full(a).detach().float(), ref.detach().float()
        return float((a - ref).abs().max()) / max(float(ref.abs().max()),
                                                  1e-30)

    for arch, impl in cases:
        cfg = configs.get_smoke(arch)
        if impl == "ep":
            # no assignment dropped and no aux loss (averaged over the
            # shards, as JAX's pmean does): the dense path's numbers
            cfg = dataclasses.replace(cfg, moe_impl=impl,
                                      moe_capacity_factor=64.0,
                                      router_aux_coef=0.0)
        elif impl:
            cfg = dataclasses.replace(cfg, moe_impl=impl)
        gen = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                             dtype=torch.int32)
        extra = transformer.stub_inputs(cfg, b, "cpu", seq=s)
        for k, v in extra.items():
            if v.is_floating_point():
                extra[k] = torch.randn(v.shape, generator=gen)
        batch = {"tokens": toks, "labels": toks, **extra}
        model = transformer.init_params(cfg, seed=0, device="cpu")
        model.requires_grad_(True)
        dmodel = copy.deepcopy(model)
        specs = rules.param_specs(model, mesh)
        for name, p in list(dmodel.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            module = dmodel.get_submodule(owner) if owner else dmodel
            setattr(module, leaf, torch.nn.Parameter(distribute_tensor(
                p.detach(), mesh, rules.placements(specs[name], mesh))))
        dbatch = _dtensor_batch(batch, rules.batch_specs(batch, mesh), mesh)
        res = {}
        loss = lm_loss(model, batch, cfg)[0]
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
        with implicit_replication():
            dloss = lm_loss(dmodel, dbatch, cfg)[0]
            dparams = dict(dmodel.named_parameters())
            dgrads = torch.autograd.grad(dloss, list(dparams.values()))
        res["loss"] = rel(dloss, loss)
        res["grads"] = max(rel(dg, g) for dg, g in zip(dgrads, grads))
        model.requires_grad_(False)
        dmodel.requires_grad_(False)
        prompt = {"tokens": toks, **{k: v for k, v in extra.items()}}
        dprompt = {k: v for k, v in dbatch.items() if k != "labels"}
        with torch.no_grad(), implicit_replication():
            last, cache = transformer.prefill(model, prompt, cfg,
                                              cache_len=cache_len)
            meta = transformer.init_cache(cfg, b, cache_len, device="cpu",
                                          encoder_seq=None)
            cspecs = rules.cache_specs(meta, mesh)
            dcache = {st: {k: distribute_tensor(
                v, mesh, rules.placements(cspecs[st][k], mesh))
                for k, v in leaves.items()} for st, leaves in meta.items()}
            dlast, dcache = transformer.prefill(dmodel, dprompt, cfg,
                                                cache_len=cache_len,
                                                cache=dcache)
            res["prefill"] = rel(dlast, last)
            res["cache"] = max(rel(dcache[st][k], v) for st, leaves in
                               cache.items() for k, v in leaves.items())
            tok = torch.argmax(last, -1)
            pos = torch.full((b,), s, dtype=torch.int32)
            steps = []
            for _ in range(new):
                step_batch = {"tokens": tok[:, None], "pos": pos}
                dstep = _dtensor_batch(step_batch, rules.batch_specs(
                    step_batch, mesh), mesh)
                logits, cache = transformer.decode_step(
                    model, tok[:, None], pos, cache, cfg)
                dlogits, dcache = transformer.decode_step(
                    dmodel, dstep["tokens"], dstep["pos"], dcache, cfg)
                steps.append(rel(dlogits, logits))
                tok, pos = torch.argmax(logits, -1), pos + 1
            res["decode"] = max(steps)
        out[f"{arch}:{impl}"] = res
    return out

"""One rank of ``tests/test_torch_distributed.py``'s and
``tests/test_torch_tp.py``'s process groups.

    python tests/torch_dist_worker.py RANK WORLD INIT_FILE JOB OUT

joins a gloo group of WORLD ranks through ``file://INIT_FILE``, runs every
case of the job (``torch.save``d by the test: {case: inputs}) in the job's
order, as every rank must, and saves {case: outputs} to OUT.  It imports
the port only, never jax.
"""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed import compression as Z  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh, make_mesh  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402


def _cfg(job):
    return dataclasses.replace(get_config(job["arch"]).smoke(),
                               dtype="float32", **job.get("cfg", {}))


def _half(x, dim, mesh, axes=("model",)):
    return SH.local_slice(x, SH.Spec(*([None] * dim), axes), mesh)


def case_lse(job):
    """lse_combine of this rank's partials."""
    mesh = make_mesh((dist.get_world_size(),), ("model",))
    r = mesh.rank
    return {"out": C.lse_combine(job["o"][r], job["m"][r], job["l"][r],
                                 mesh, ("model",))}


def case_seq_attn(job):
    """The sequence-sharded decode attention over this rank's half of the
    ring."""
    mesh = make_mesh((dist.get_world_size(),), ("model",))
    fn = C.make_seq_sharded_attn(mesh, (), ("model",))
    out = {}
    for softcap in job["softcaps"]:
        out[f"softcap{softcap:g}"] = fn(
            job["q"], _half(job["k"], 1, mesh), _half(job["v"], 1, mesh),
            _half(job["valid"], 1, mesh), scale=job["scale"],
            attn_softcap=softcap)
    return out


def case_ep(job):
    """A plan-style MoE shard fn on one layer's MoE leaves, sliced as its
    specs say."""
    cfg = _cfg(job)
    sizes, names = job["mesh"]
    mesh = make_mesh(sizes, names)
    fn = C.make_moe_shard_fn(mesh, cfg, variant=job["variant"], dp_axes=(),
                             expert_axes=tuple(job["expert_axes"]),
                             capacity_factor=8.0,
                             ffn_axes=tuple(job.get("ffn_axes", ())))
    p = SH.shard_tree(params_from_numpy(job["p"], "cpu"), fn.p_specs, mesh)
    out, aux = fn(cfg, p, job["x"])
    return {"out": out, "aux": aux}


def case_compress(job):
    """compressed_psum of this rank's gradients, one step per method, and
    int8 error feedback over the steps of ``job["ef"]``."""
    group = dist.group.WORLD
    r = dist.get_rank()
    out = {}
    for method in ("int8", "bf16", "none"):
        o, e = Z.compressed_psum(job["g"][r], group, method=method)
        out[method] = {"out": o, "err": e}
    err, total = None, 0
    for g in job["ef"][r]:
        o, err = Z.compressed_psum(g, group, method="int8", error=err)
        total = total + o
    out["ef"] = {"sum": total, "err": err}
    tree, errs = Z.tree_compressed_psum(job["tree"][r], group, method="bf16")
    out["tree"] = {"out": tree, "err": errs}
    return out


def case_elastic(job):
    """restore_elastic of a checkpoint written whole, on a (1, WORLD)
    mesh."""
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.runtime.elastic import restore_elastic
    cfg = _cfg(job)
    mesh = make_debug_mesh(model=dist.get_world_size(), data=1)
    step, tree, extra, plan = restore_elastic(
        CheckpointManager(job["dir"]), cfg, get_shape(job["shape"]).smoke(),
        mesh)
    return {"step": step, "tree": tree, "extra": extra,
            "variant": plan.moe_variant}


def _serve(cfg, params, prompt, steps, policy):
    from repro_torch.models import kvcache
    from repro_torch.models.model import forward
    from repro_torch.serving.steps import make_serve_step
    B, S = prompt.shape
    cache = kvcache.init_cache(cfg, B, S + steps, device="cpu")
    forward(cfg, params, prompt, cache=cache, mode="prefill")
    step = make_serve_step(cfg, policy)
    tok, logits, toks = prompt[:, -1:], [], []
    for _ in range(steps):
        nxt, lg, cache = step(params, cache, tok)
        logits.append(lg)
        toks.append(nxt)
        tok = nxt[:, None].long()
    return {"logits": torch.stack(logits), "tokens": torch.stack(toks)}


def case_serve(job):
    """Greedy decode through make_serve_step under each mesh's plan."""
    cfg = _cfg(job)
    params = params_from_numpy(job["params"], "cpu")
    shape = dataclasses.replace(get_shape("decode_32k"),
                                global_batch=job["prompt"].shape[0],
                                seq_len=job["prompt"].shape[1]
                                + job["steps"])
    out = {}
    with torch.no_grad():
        for sizes, names in job["meshes"]:
            plan = SH.make_plan(cfg, shape, make_mesh(sizes, names))
            out["x".join(map(str, sizes)) + ":" + plan.moe_variant] = \
                _serve(cfg, params, job["prompt"], job["steps"],
                       plan.policy)
    return out


def case_train(job):
    """One train step under the train plan of a ("model",) mesh, with
    remat on and off, on fresh parameters each time (AdamW updates them
    in place)."""
    from repro_torch.training import optimizer as t_opt
    from repro_torch.training import train_step as t_step
    cfg = _cfg(job)
    mesh = make_mesh((dist.get_world_size(),), ("model",))
    out = {}
    for remat in (True, False):
        plan = SH.make_plan(cfg, get_shape("train_4k").smoke(), mesh,
                            remat=remat)
        params = t_step.requires_grad_(params_from_numpy(job["params"],
                                                         "cpu"))
        _, _, grads = t_step.value_and_grad(
            t_step.make_loss_fn(cfg, plan.policy), params, job["batch"])
        opt = t_opt.OptConfig(warmup_steps=2)
        state = t_opt.init_opt_state(params, opt)
        new_p, new_s, metrics = t_step.make_train_step(
            cfg, opt, plan.policy)(params, state, job["batch"])
        out[f"remat{int(remat)}"] = {
            "variant": plan.moe_variant,
            "grads": t_opt.tree_map(
                lambda g: None if g is None else g.detach(), grads),
            "new_params": t_opt.tree_map(lambda p: p.detach(), new_p),
            "new_state": new_s,
            "metrics": {k: float(v) for k, v in metrics.items()}}
    return out


def _tp_plan(job, shape):
    """The job's config, and its plan on the job's mesh over this group."""
    cfg = _cfg(job)
    sizes, names = job["mesh"]
    mesh = make_mesh(sizes, names)
    return cfg, mesh, SH.make_plan(cfg, shape, mesh)


def _rows(x, plan, mesh):
    """This rank's rows of a batch leaf over the plan's dp axes."""
    return SH.local_slice(x, SH.Spec(plan.dp_axes or None), mesh)


def case_tp_serve(job):
    """A prefill and greedy steps through ``make_serve_step`` under the
    job's decode plan, each rank on its slices of the weights, its rows of
    the batch and its slots of the ring."""
    from repro_torch.models import kvcache
    from repro_torch.models.model import forward
    from repro_torch.serving.steps import make_serve_step
    prompt, steps = job["prompt"], job["steps"]
    B, S = prompt.shape
    shape = dataclasses.replace(get_shape("decode_32k"), global_batch=B,
                                seq_len=S + steps)
    cfg, mesh, plan = _tp_plan(job, shape)
    params = SH.shard_tree(params_from_numpy(job["params"], "cpu"),
                           plan.param_specs, mesh)
    cache = kvcache.init_cache(cfg, B, S + steps, device="cpu")
    cache = {k: (v if k == "pos" else {n: t.contiguous() for n, t in
                                       v.items()})
             for k, v in SH.shard_tree(cache, SH.cache_specs(
                 cfg, cache, plan.dp_axes, plan.kv_axes, plan.rules, mesh),
                 mesh).items()}
    prompt = _rows(prompt, plan, mesh)
    step = make_serve_step(cfg, plan.policy)
    logits, toks = [], []
    with torch.no_grad():
        forward(cfg, params, prompt, cache=cache, mode="prefill",
                policy=plan.policy)
        tok = prompt[:, -1:]
        for _ in range(steps):
            nxt, lg, cache = step(params, cache, tok)
            logits.append(lg)
            toks.append(nxt)
            tok = nxt[:, None].long()
    return {"variant": plan.moe_variant, "dp_index": mesh.axis_index(
        plan.dp_axes), "logits": torch.stack(logits),
        "tokens": torch.stack(toks)}


def case_tp_train(job):
    """One train step under the job's train plan on this rank's slices
    (cloned, so AdamW updates them alone) and rows: its gradients (after
    the dp sums), metrics and the updated slices."""
    from repro_torch.training import optimizer as t_opt
    from repro_torch.training import train_step as t_step
    cfg, mesh, plan = _tp_plan(job, get_shape("train_4k").smoke())
    params = t_opt.tree_map(lambda t: t.clone(), SH.shard_tree(
        params_from_numpy(job["params"], "cpu"), plan.param_specs, mesh))
    t_step.requires_grad_(params)
    batch = {k: _rows(v, plan, mesh) for k, v in job["batch"].items()}
    _, _, grads = t_step.value_and_grad(
        t_step.make_loss_fn(cfg, plan.policy), params, batch,
        plan.policy.shard)
    opt = t_opt.OptConfig(warmup_steps=2)
    state = t_opt.init_opt_state(params, opt)
    new_p, _, metrics = t_step.make_train_step(cfg, opt, plan.policy)(
        params, state, batch)
    micro = {}
    if job.get("num_micro"):
        params = t_step.requires_grad_(t_opt.tree_map(
            lambda t: t.clone(), SH.shard_tree(params_from_numpy(
                job["params"], "cpu"), plan.param_specs, mesh)))
        _, _, m = t_step.make_microbatched_train_step(
            cfg, opt, plan.policy, job["num_micro"])(
            params, t_opt.init_opt_state(params, opt), batch)
        micro = {k: float(v) for k, v in m.items()}
    return {"variant": plan.moe_variant, "micro": micro,
            "grads": t_opt.tree_map(
                lambda g: None if g is None else g.detach(), grads),
            "new_params": t_opt.tree_map(lambda p: p.detach(), new_p),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def case_tp_pairs(job):
    """The conjugate pairs' gradients at this group's size: a replicated
    activation through the dense FFN split by ``ffn`` and through the
    ``ep_a2a`` body under the train plan of a ("model",) mesh (loss
    sum(y^2) + aux, every rank alike), and the refusal of a backward
    through ``ep_psum``."""
    from repro_torch.models.model import dense_ffn
    cfg = _cfg(job)
    mesh = make_mesh((dist.get_world_size(),), ("model",))
    plan = SH.make_plan(cfg, get_shape("train_4k").smoke(), mesh)
    shard = plan.policy.shard
    blocks = SH.shard_tree(params_from_numpy(job["params"], "cpu"),
                           plan.param_specs, mesh)["blocks"]["p0"]
    out = {}
    ffn = {"wi": SH.local_slice(job["ffn"]["wi"], SH.Spec(None, None,
                                                          "model"), mesh),
           "wo": SH.local_slice(job["ffn"]["wo"], SH.Spec("model"), mesh)}
    x = job["x"].clone().requires_grad_(True)
    y = dense_ffn(cfg, ffn, x, shard)
    y.square().sum().backward()
    out["ffn"] = {"y": y.detach(), "dx": x.grad}
    moe = {k: v[0].clone().requires_grad_(True)
           for k, v in blocks["moe"].items()}
    x = job["x"].clone().requires_grad_(True)
    y, aux = plan.policy.moe_fn(cfg, moe, x)
    (y.square().sum() + aux).backward()
    out["a2a"] = {"y": y.detach(), "aux": aux.detach(), "dx": x.grad,
                  "grads": {k: v.grad for k, v in moe.items()}}
    psum = C.make_moe_shard_fn(mesh, cfg, variant="ep_psum", dp_axes=(),
                               expert_axes=("model",), tp=True)
    try:
        psum(cfg, moe, job["x"].clone().requires_grad_(True))
        out["psum_raised"] = ""
    except NotImplementedError as e:
        out["psum_raised"] = str(e)
    return out


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def main() -> None:
    rank, world, init_file, job_path, out_path = sys.argv[1:6]
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=int(rank), world_size=int(world))
    try:
        out = {name: CASES[name.split(":")[0]](inputs)
               for name, inputs in job.items()}
    finally:
        dist.destroy_process_group()
    torch.save(out, out_path)


if __name__ == "__main__":
    main()

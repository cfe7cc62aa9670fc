"""The per-rank bodies of the port's multi-process CPU tests
(tests/test_torch_parallel_dp.py, test_torch_sharded_cache.py,
test_torch_depth_sharded.py, test_torch_tp.py).

``parallel.mesh.spawn`` runs each in N new processes joined by gloo; a
spawned process imports this module by name, so it imports the port only,
never JAX.  Each returns host values (floats, CPU tensors) from rank 0.
"""

import numpy as np
import torch

from representation_disentanglement_torch.config import Config
from representation_disentanglement_torch.models.multimodal import (
    MultimodalModel, build_model)
from representation_disentanglement_torch.models.unet3d import build_nvnet3d
from representation_disentanglement_torch.parallel import halo, mesh, tp
from representation_disentanglement_torch.training import (
    evaluate as ev, optim, train, train3d)


def z_is_the_mean():
    MultimodalModel.sample_z = lambda self, gen, m, lv: m


def port_2d(kw, sd, device="cpu"):
    cfg = Config(**kw).derive().validate()
    model = build_model(cfg, device=device)
    model.load_state_dict(sd, strict=True)
    return cfg, model


def dp_steps(kw, sd, batch, pairs, steps, z_mean, seed, device):
    """``steps`` DP train steps of the rank's rows of ``batch`` (global,
    microbatch-stacked) from the weights ``sd``: (metrics per step, the
    state dict after)."""
    if z_mean:
        z_is_the_mean()
    axis = mesh.whole_axis()
    cfg, model = port_2d(kw, sd, device)
    opt = optim.make_optimizer(model.parameters(), cfg)
    dopt = optim.make_d_optimizer(model.parameters(), cfg) \
        if cfg.is_discrim_s else None
    step = train.make_train_step(model, cfg, opt, dopt, mesh=axis)
    gen = torch.Generator(device=device).manual_seed(seed)
    local = mesh.shard_batch(batch, axis, stacked=True)
    metrics = [train.metrics_to_dict(step(local, gen, pairs, pairs,
                                          first_of_epoch=(i == 0)))
               for i in range(steps)]
    return metrics, {k: v.detach().cpu().clone()
                     for k, v in model.state_dict().items()}


def dp_eval(kw, sd, batches, rank_local, device):
    """``evaluate`` on the mesh over ``batches`` (global; with
    ``rank_local`` each rank is given its rows, with ``valid``)."""
    axis = mesh.whole_axis()
    cfg, model = port_2d(kw, sd, device)

    class Loader(list):
        pass

    loader = Loader(mesh.shard_batch(b, axis) if rank_local else b
                    for b in batches)
    loader.rank_local = rank_local
    return ev.evaluate(model, cfg, loader, mesh=axis)


def volume_steps(hwd, init, n_depth, n_data, sd, batch, seed, device):
    """The depth-sharded inference from ``sd``, then one sharded NVNet3D
    train step on the (n_data x n_depth) mesh: (metrics, state dict after
    the step, inference outputs)."""
    model = build_nvnet3d(hwd, in_channels=batch["inputs"].shape[1],
                          init_channels=init, device=device)
    model.load_state_dict(sd)
    opt = train3d.create_state_3d(model)
    vm = halo.make_volume_mesh(n_data, n_depth) if n_data > 1 \
        else halo.make_depth_mesh(n_depth)
    step = train3d.make_sharded_train_step_3d(model, opt, vm)
    gen = None if seed is None else torch.Generator(device=device) \
        .manual_seed(seed)
    infer = halo.sharded_nvnet_infer_fn(
        model, halo.VolumeMesh(vm.depth, None, vm.depth))
    out = infer(batch["inputs"])
    m = step(batch, gen)
    return ({k: float(v) for k, v in m.items()},
            {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()},
            [o.cpu() for o in out])


def tp_forward(hwd, init, sd, x, device):
    """NVNet3D's eval forward under channel TP over the whole group."""
    model = build_nvnet3d(hwd, in_channels=x.shape[1], init_channels=init,
                          device=device)
    model.load_state_dict(sd)
    with torch.no_grad(), tp.channel_parallel(mesh.whole_axis()):
        return [o.cpu() for o in model(x)]


def halo_grad(x, device):
    """The halo exchange of this rank's depth block of ``x`` and the
    gradient of sum(w * halo(x)) for w = the global index."""
    axis = mesh.whole_axis()
    from representation_disentanglement_torch.ops.conv3d import (
        halo_exchange)
    xl = mesh.local_rows(x, 4, axis).clone().requires_grad_(True)
    y = halo_exchange(xl, 1, axis)
    w = torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape)
    (y * w).sum().backward()
    gather = lambda t: torch.cat(halo._all_gather(t.contiguous(), axis), 0)
    return gather(y.detach()[None]), gather(xl.grad[None])


def np_batch(rs, a, m, b, h, w, cb):
    x = rs.normal(size=(a, m, b, h, w, cb)).astype(np.float32)
    x[:, :, :, :4] = 0.0
    x[0, 0, 1] = 0.0
    mask = np.ones((a, b, m), np.float32)
    mask[0, 1, 0] = 0.0
    mask_img = (x[:, 1, :, :, :, 0] == 0).astype(np.float32)
    return {"inputs": x, "mask": mask, "mask_img": mask_img,
            "targets": np.zeros((a, b, h, w, 1), np.float32)}


def run_jobs(jobs, device):
    """Several of the functions above in one set of processes: ``jobs`` is
    a list of (name, args); returns their results in order."""
    return [globals()[name](*args, device=device) for name, args in jobs]


def sharded_epoch(kw, sd, vols, subj_list, idx_list, device):
    """One epoch over the sharded train cache on the mesh: (metrics [steps,
    K] of the epoch, the state dict after, the global composition of the
    plan: subject names and slices [steps, A, B] in global batch order,
    and drop [steps, A, B, M])."""
    from representation_disentanglement_torch.data.dataset import (
        VolumeStore)
    from representation_disentanglement_torch.data.device_store import (
        ShardedDeviceBatchLoader, build_sharded_device_cache)
    from representation_disentanglement_torch.training import epoch
    axis = mesh.whole_axis()
    cfg, model = port_2d(kw, sd, device)
    cache = build_sharded_device_cache(
        "BraTS", VolumeStore(data=vols), subj_list, cfg.contrast_list,
        axis, cfg.block_size, dtype=torch.float32, device=device)
    loader = ShardedDeviceBatchLoader(cache, subj_list, idx_list,
                                      cfg.batch_size, shuffle=True,
                                      seed=cfg.seed)
    opt = optim.make_optimizer(model.parameters(), cfg)
    run_epoch, n_micro = epoch.make_train_epoch(model, cfg, opt, cache,
                                                None, mesh=axis)
    plan = epoch.epoch_indices(loader, n_micro, cfg.modality_num,
                               np.random.default_rng(cfg.seed))
    metrics = run_epoch(plan, True)
    names = np.array(cache.subjects)[axis.rank * cache.s_loc
                                     + plan.rows.cpu().numpy()]
    def gather(a, dim):
        parts = [None] * axis.size
        torch.distributed.all_gather_object(parts, np.asarray(a))
        return np.concatenate(parts, dim)

    return (metrics.cpu(), {k: v.detach().cpu().clone()
                            for k, v in model.state_dict().items()},
            gather(names, 2), gather(plan.slices.cpu().numpy(), 2),
            gather(plan.drop.cpu().numpy(), 2), plan.sim, plan.adv)

"""The rank bodies of ``tests/test_torch_port_dp.py``, run in processes
spawned by :func:`pvo_tpu_torch.parallel.data_parallel.spawn` (a
module of its own: a spawned rank imports it, and it imports no JAX).

Each scenario runs on this rank's slice of a global batch and returns
numpy: the parameters after the steps and what the test holds.
"""

import numpy as np
import torch

from pvo_tpu_torch.parallel import data_parallel as dp
from pvo_tpu_torch.parallel import multihost as mh
from pvo_tpu_torch.scripts.bench_track import tame_net
from pvo_tpu_torch.scripts.train_vo import restart_passes
from pvo_tpu_torch.vps import train as vtrain
from pvo_tpu_torch.vps.panoptic_fpn import PanopticFPN

# the VO scenarios: 48x64, F=4, two iterations, two steps
VO_ITERS, VO_STEPS, F = 2, 2, 4
II, JJ = dp.losses.ring_graph(F)
# the VPS scenario's proposals (tests/test_torch_port_vps_train.py's)
VPS_LOSS_KW = dict(max_props=64, pre_nms_topk=128)
VPS_BLOCKS = (1, 1, 1, 1)


def numpy_params(model):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def vo_model(mesh, seed):
    """Tamed random weights from ``seed`` (``bench_track.tame_net``: on
    untamed ones a 1e-7 change of the weights moves the next step's loss
    by a quarter), then rank 0's weights on every rank."""
    return dp.replicate(tame_net(seed, mask_bias=-2.0).to(mesh.device)
                        .train(), mesh)


def grad_recorder(model, tx):
    """Wraps ``tx.step`` to record the gradients it applies (after the
    all-reduce) as numpy; returns the list of records."""
    seen, step = [], tx.step

    def recorded():
        seen.append({n: p.grad.detach().cpu().numpy().copy()
                     for n, p in model.named_parameters()
                     if p.grad is not None})
        step()

    tx.step = recorded
    return seen


def vo_train_steps(mesh, global_batch, seed=0):
    """``VO_STEPS`` steps of ``make_train_step`` (sup)."""
    model = vo_model(mesh, seed)
    tx = dp.make_optimizer(model.parameters(), total_steps=100)
    grads = grad_recorder(model, tx)
    step = dp.make_train_step(model, tx, II, JJ, num_steps=VO_ITERS,
                              mode="sup", mesh=mesh)
    batch = dp.to_device(dp.shard_batch(global_batch, mesh.rank, mesh.world),
                         mesh.device)
    state, losses = dp.TrainState(model, tx), []
    for _ in range(VO_STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return {"params": numpy_params(model), "losses": losses, "grads": grads}


def vo_restart_steps(mesh, global_batch, rng_seed, seed=0):
    """``VO_STEPS`` outer steps of the restart loop (sup), the restart
    draws from ``restart_rng(rng_seed)``."""
    model = vo_model(mesh, seed)
    tx = dp.make_optimizer(model.parameters(), total_steps=100)
    seen = grad_recorder(model, tx)
    pass_fn, apply_fn, acc_fn = dp.make_restart_step(
        model, tx, II, JJ, num_steps=VO_ITERS, mode="sup", mesh=mesh)
    batch = dp.to_device(dp.shard_batch(global_batch, mesh.rank, mesh.world),
                         mesh.device)
    rng = dp.restart_rng(rng_seed, mesh)
    state, passes, losses = dp.TrainState(model, tx), [], []
    for _ in range(VO_STEPS):
        loss, metrics, grads, n = restart_passes(pass_fn, acc_fn, batch, rng)
        metrics = {"loss": loss, **metrics}
        state = apply_fn(state, grads, metrics)
        passes.append(n)
        losses.append(float(metrics["loss"]))
    return {"params": numpy_params(model), "passes": passes,
            "losses": losses, "grads": seen, "next_draws": rng.random(4)}


def vps_steps(mesh, state_dict, global_batch, priorities, lr=1e-3):
    """``len(priorities)`` steps of ``make_full_train_step_dp`` on the
    1-block Panoptic FPN from ``state_dict``, the RPN subsample of step
    k on ``priorities[k]``, detectron2's solver without warmup."""
    model = PanopticFPN(backbone_blocks=VPS_BLOCKS)
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in state_dict.items()})
    model = dp.replicate(model.to(mesh.device).train(), mesh)
    tx = vtrain.make_solver(model, base_lr=lr, warmup_iters=0)

    def rng_fn(step, device):
        return torch.as_tensor(np.array(priorities[step]), device=device)

    step = vtrain.make_full_train_step_dp(model, tx, mesh, rng_fn=rng_fn,
                                          **VPS_LOSS_KW)
    local = dp.shard_batch(global_batch, mesh.rank, mesh.world)
    batch = {k: torch.stack([vtrain.to_device({k: v[b]}, mesh.device)[k]
                             for b in range(len(v))])
             for k, v in local.items()}
    state, metrics, first = vtrain.TrainState(model, tx), [], None
    for k in range(len(priorities)):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if k == 0 and mesh.rank == 0:
            first = numpy_params(model)
    return {"params": numpy_params(model), "metrics": metrics,
            "first_params": first}


def multihost_helpers(mesh):
    """What each multihost helper gives on this rank."""
    x = np.full((2, 3), mesh.rank, np.float32)
    g = mh.global_batch_from_local({"x": x})
    payloads = mh.gather_payloads([{"rank": mesh.rank}, mesh.rank * 10])
    mh.sync()
    return {"count": mh.process_count(), "main": mh.is_main_process(),
            "global": g["x"].numpy(), "payloads": payloads}


def cli_refusals(mesh):
    """What the trainers' CLIs raise for a global batch of 3 on this
    group (before they read any data)."""
    from pvo_tpu_torch.scripts import train_vo, train_vps
    out = {}
    for name, main in (("train_vo", train_vo.main),
                       ("train_vps", train_vps.main)):
        try:
            main(["--datapath", "no_such_root", "--batch", "3",
                  "--device", "cpu"])
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def all_scenarios(mesh, inputs):
    """Every scenario on this rank, one process group for all."""
    return {
        "multihost": multihost_helpers(mesh),
        "cli": cli_refusals(mesh),
        "train": vo_train_steps(mesh, inputs["vo_batch"],
                                seed=mesh.rank),
        "restart": vo_restart_steps(mesh, inputs["vo_batch"],
                                    inputs["rng_seed"] + mesh.rank),
        "vps": vps_steps(mesh, inputs["vps_state"], inputs["vps_batch"],
                         inputs["priorities"]),
    }

"""Inverse rendering: recover scene parameters from target images.

New capability beyond the reference (which is forward-only): because the
whole pipeline — ray generation, the root solve (via its implicit-function-
theorem VJP, ops/intersect.py), shading, and the reflection chain — is
differentiable, scene parameters can be optimized by gradient descent to
match a target image (BASELINE.json config: recover clebsch.yml's surface
coefficients + light parameters from a rendered target).

Distributed layout: pixel rows sharded over the mesh, parameters replicated;
the parameter-gradient all-reduce (``psum``) is inserted by AD through
``shard_map``. Gradients always run ``jax.grad`` through the XLA pipeline
(``render/route.py``).

Checkpoint/resume (the reference has none — SURVEY.md §5) saves the
optimized parameters + optimizer state as an .npz with tree-path keys.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..models.scene import Scene
from ..ops import camera as camera_ops
from ..parallel.sharding import AXIS, make_mesh, padded_rows
from ..render.pipeline import RenderConfig, render_rays, resolve_bounces


# --- parameterization ---

DEFAULT_PARAM_FIELDS = ("coefs", "light_color")


def extract_params(scene: Scene, fields=DEFAULT_PARAM_FIELDS,
                   camera=None) -> dict:
    """Pull the optimizable leaves out of a scene.

    The pseudo-field ``"camera"`` optimizes the camera pose itself (the
    ``Camera`` pytree — position, yaw, pitch) rather than a Scene table:
    the reference's fly camera IS a pose (src/ray-tracer.cpp:24-58), and
    the differentiable render carries cotangents back to it, so pose
    estimation is a first-class inverse problem. Pass the initial-guess
    ``camera`` when requesting it."""
    params = {}
    for name in fields:
        if name == "camera":
            if camera is None:
                raise ValueError(
                    "param field 'camera' needs an initial pose: pass "
                    "camera= to extract_params/fit")
            params["camera"] = camera
        else:
            params[name] = getattr(scene, name)
    return params


def apply_params(scene: Scene, params: dict) -> Scene:
    """Graft optimized leaves back onto a scene template (the ``camera``
    pseudo-field is not a Scene table and is skipped — the render path
    consumes it directly)."""
    updates = {k: v for k, v in params.items() if k != "camera"}
    return dataclasses.replace(scene, **updates)


# --- training step ---

@dataclasses.dataclass(frozen=True)
class InverseProblem:
    """Static description of one inverse-rendering run."""

    scene_template: Scene          # concrete scene (non-optimized leaves used as-is)
    config: RenderConfig = RenderConfig(polish_iters=3)
    param_fields: tuple = DEFAULT_PARAM_FIELDS
    learning_rate: float = 1e-2
    grad_clip: float | None = None  # optional global-norm clip; note IFT
    #                                 gradients spike at grazing hits, and a
    #                                 global clip pins the direction to those
    #                                 spikes — prefer per-coordinate Adam alone
    soft_tau: float | None = None  # soft-visibility temperature: render the
    #                                 loss through diff/soft.py so descent can
    #                                 cross root-selection discontinuities
    #                                 (multi-sheet surface-coefficient
    #                                 recovery); None = hard render. Forces
    #                                 the XLA path; bounce-free scenes only.

    def optimizer(self):
        if self.grad_clip is not None:
            return optax.chain(
                optax.clip_by_global_norm(self.grad_clip),
                optax.adam(self.learning_rate),
            )
        return optax.adam(self.learning_rate)


def _device_render(scene: Scene, camera, rows_local: int, config: RenderConfig,
                   bounces: int, soft_tau: float | None = None,
                   pair_kinds=None):
    """Per-device row-block render (shard_map body)."""
    idx = jax.lax.axis_index(AXIS)
    y0 = idx * rows_local
    rotation, eye = camera_ops.camera_frame(camera)
    dirs = camera_ops.pixel_directions(
        rotation, scene.width, scene.height, scene.aspect_ratio,
        scene.tan_half_fov, y0=y0, rows=rows_local,
    )
    origin = jnp.broadcast_to(eye, dirs.shape)
    if soft_tau is not None:
        from .soft import render_rays_soft
        return render_rays_soft(scene, origin, dirs,
                                polish_iters=config.polish_iters,
                                tau=soft_tau, pair_kinds=pair_kinds)
    return render_rays(scene, origin, dirs,
                       polish_iters=config.polish_iters, bounces=bounces)


def make_loss_fn(problem: InverseProblem, mesh):
    """Build ``loss(params, camera, target_padded) -> scalar`` with rows
    sharded over `mesh`. target_padded: [Hp, W, 3] (Hp = padded rows),
    rows beyond scene.height are masked out of the loss."""
    from jax.sharding import PartitionSpec as P

    # jnp-ify the closed-over template: it never crosses a jit boundary, and
    # numpy leaves would fail under traced indexing (colors[idx]).
    bounces = resolve_bounces(problem.scene_template, problem.config)
    template = jax.tree.map(
        jnp.asarray, problem.scene_template.astype(problem.config.dtype)
    )
    n_dev = mesh.shape[AXIS]
    height_padded = padded_rows(template.height, n_dev)
    rows_local = height_padded // n_dev
    n_valid = template.height * template.width * 3

    if problem.soft_tau is not None and bounces != 0:
        raise ValueError("soft_tau requires a bounce-free configuration")
    # Static per-object pair-kind routing for the soft blend: derived from
    # the TEMPLATE so quadric-class objects keep the numerically accurate
    # quadratic discriminant even when descent drifts their cubic entries
    # off zero (diff/soft.py, pair_coverage docstring).
    pair_kinds = tuple(
        bool(x) for x in
        (np.abs(np.asarray(problem.scene_template.coefs)[:, :10]) > 0).any(1)
    ) if problem.soft_tau is not None else None

    def device_loss(params, camera, target_local, tau=None):
        scene = apply_params(template, params)
        # pose optimization: the optimized camera overrides the fixed one
        # (gradients chain through camera_frame to (position, yaw, pitch)
        # cotangents automatically)
        camera = params.get("camera", camera)
        y0 = jax.lax.axis_index(AXIS) * rows_local
        colors = _device_render(scene, camera, rows_local, problem.config,
                                bounces, tau, pair_kinds=pair_kinds)
        # mask padded rows out of the squared error
        row_ids = y0 + jnp.arange(rows_local)
        valid = (row_ids < scene.height)[:, None, None]
        err = jnp.where(valid, colors - target_local, 0.0)
        local_sse = jnp.sum(err * err)
        return jax.lax.psum(local_sse, AXIS)

    # check_vma=False: the root solve's custom VJP produces device-varying
    # cotangents for the replicated parameters; with varying-axis checking
    # off, shard_map's transpose psums them at the P() boundary (the
    # standard escape hatch for custom_vjp inside shard_map).
    if problem.soft_tau is None:
        sharded = jax.shard_map(
            device_loss,
            mesh=mesh,
            in_specs=(P(), P(), P(AXIS)),
            out_specs=P(),
            check_vma=False,
        )

        def loss(params, camera, target_padded):
            return sharded(params, camera, target_padded) / n_valid
    else:
        # soft-visibility loss: the temperature is a TRACED argument so a
        # tau-continuation schedule (anneal toward the hard loss) reuses one
        # compiled executable across the whole run
        sharded = jax.shard_map(
            device_loss,
            mesh=mesh,
            in_specs=(P(), P(), P(AXIS), P()),
            out_specs=P(),
            check_vma=False,
        )

        def loss(params, camera, target_padded, tau=problem.soft_tau):
            tau = jnp.asarray(tau, template.coefs.dtype)
            return sharded(params, camera, target_padded, tau) / n_valid

    return loss


def make_train_step(problem: InverseProblem, mesh=None):
    """Build a jitted ``train_step(params, opt_state, camera, target) ->
    (params, opt_state, loss)`` with the gradient all-reduce over the mesh."""
    if mesh is None:
        mesh = make_mesh()
    loss_fn = make_loss_fn(problem, mesh)
    optimizer = problem.optimizer()

    if problem.soft_tau is None:
        @jax.jit
        def train_step(params, opt_state, camera, target_padded):
            loss, grads = jax.value_and_grad(loss_fn)(
                params, camera, target_padded)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss
    else:
        @jax.jit
        def train_step(params, opt_state, camera, target_padded,
                       tau=problem.soft_tau):
            loss, grads = jax.value_and_grad(loss_fn)(
                params, camera, target_padded, tau)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

    return train_step


def pad_target(target, mesh, height: int):
    """Pad a [H, W, 3] target to the mesh-divisible row count."""
    n_dev = mesh.shape[AXIS]
    hp = padded_rows(height, n_dev)
    pad = hp - target.shape[0]
    if pad:
        target = jnp.concatenate(
            [jnp.asarray(target), jnp.zeros((pad,) + target.shape[1:], target.dtype)]
        )
    return target


def tau_schedule(tau0: float, tau_final: float, steps: int):
    """Geometric continuation schedule tau0 -> tau_final over ``steps``."""
    if steps <= 1:
        return [tau_final]
    ratio = (tau_final / tau0) ** (1.0 / (steps - 1))
    return [tau0 * ratio ** i for i in range(steps)]


def fit(problem: InverseProblem, target, camera=None, steps: int = 200,
        mesh=None, log_every: int = 25, print_fn=print,
        checkpoint_path=None, checkpoint_every: int = 0,
        tau_final: float | None = None):
    """Run the optimization loop; returns (params, losses).

    ``tau_final`` (soft-visibility problems only) turns the run into a
    continuation: the temperature anneals geometrically from
    ``problem.soft_tau`` down to ``tau_final`` across the steps, so descent
    first sees smooth gradients across root-pair events and finishes on an
    objective that has converged to the hard render (tau -> 0 limit;
    diff/soft.py). The temperature is a traced argument — one compile for
    the whole schedule."""
    if mesh is None:
        mesh = make_mesh()
    if camera is None:
        camera = camera_ops.Camera.initial(problem.config.dtype)
    camera = jax.tree.map(lambda x: jnp.asarray(x, problem.config.dtype), camera)

    params = extract_params(problem.scene_template.astype(problem.config.dtype),
                            problem.param_fields, camera=camera)
    optimizer = problem.optimizer()
    opt_state = optimizer.init(params)
    step0 = 0
    if checkpoint_path is not None:
        restored = load_checkpoint(checkpoint_path, params, opt_state)
        if restored is not None:
            params, opt_state, step0 = restored
            print_fn(f"resumed from {checkpoint_path} at step {step0}")

    train_step = make_train_step(problem, mesh)
    target_padded = pad_target(jnp.asarray(target, jnp.float32), mesh,
                               problem.scene_template.height)
    taus = None
    if tau_final is not None:
        if problem.soft_tau is None:
            raise ValueError("tau_final requires a soft_tau problem")
        taus = tau_schedule(problem.soft_tau, tau_final, steps)
    losses = []
    for step in range(step0, steps):
        if taus is not None:
            params, opt_state, loss = train_step(
                params, opt_state, camera, target_padded, taus[step])
        else:
            params, opt_state, loss = train_step(
                params, opt_state, camera, target_padded)
        losses.append(float(loss))
        if log_every and (step % log_every == 0 or step == steps - 1):
            print_fn(f"step {step}: loss {float(loss):.3e}")
        if checkpoint_path and checkpoint_every and (step + 1) % checkpoint_every == 0:
            # process-0-gated: in a multi-process job every process holds
            # identical replicated params/opt_state, and the checkpoint path
            # typically lives on a shared filesystem — ungated saves would
            # race P concurrent np.savez writes on one file
            if jax.process_index() == 0:
                save_checkpoint(checkpoint_path, params, opt_state, step + 1)
    return params, losses


# --- checkpointing (.npz with tree-path keys) ---

def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)  # namedtuple (optax states)
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        # dataclass pytrees (e.g. the Camera pose param)
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
        return out
    for key, value in items:
        out.update(_flatten(value, f"{prefix}{key}/"))
    return out


def save_checkpoint(path, params, opt_state, step: int) -> None:
    """Atomic write (temp file + rename): a crash mid-save, or a reader
    racing the writer, never observes a truncated .npz."""
    import os

    flat = _flatten({"params": params, "opt": opt_state})
    flat["__step__"] = np.asarray(step)
    tmp = f"{path}.tmp.{os.getpid()}"
    np.savez(tmp, **flat)
    # np.savez appends .npz when the target lacks it; mirror that here
    saved = tmp if os.path.exists(tmp) else tmp + ".npz"
    os.replace(saved, path)


def load_checkpoint(path, params_like, opt_like):
    """Restore (params, opt_state, step) from `path`; None if absent."""
    import os

    if not os.path.exists(path):
        return None
    data = np.load(path)
    step = int(data["__step__"])

    def rebuild(tree, prefix):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if hasattr(tree, "_fields"):
            return type(tree)(*(rebuild(v, f"{prefix}{k}/")
                                for k, v in zip(tree._fields, tree)))
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tree))
        if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            return type(tree)(**{
                f.name: rebuild(getattr(tree, f.name), f"{prefix}{f.name}/")
                for f in dataclasses.fields(tree)
            })
        key = prefix.rstrip("/")
        return jnp.asarray(data[key]) if key in data else tree

    return (
        rebuild(params_like, "params/"),
        rebuild(opt_like, "opt/"),
        step,
    )

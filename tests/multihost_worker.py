"""Worker process for the 2-process multihost integration test.

NOT a test file: tests/test_multihost.py spawns two of these with distinct
JAX_PROCESS_ID against one localhost coordinator. Each worker initializes
jax.distributed through tpu_ray_tracer.parallel.multihost, builds the
global pixel mesh spanning BOTH processes' devices, renders a sharded frame
through the fused kernel (Pallas interpreter on CPU), runs one distributed
train step (gradient psum across processes over gloo), and writes a JSON
result the test asserts on.
"""

import dataclasses
import json
import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = int(sys.argv[3])
outdir = sys.argv[4]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
# initialize_distributed reads the standard environment
os.environ["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
os.environ["JAX_NUM_PROCESSES"] = str(nproc)
os.environ["JAX_PROCESS_ID"] = str(pid)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

from tpu_ray_tracer.utils.cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

import tpu_ray_tracer as trt  # noqa: E402
from tpu_ray_tracer.diff.inverse import (  # noqa: E402
    InverseProblem, extract_params, make_train_step, pad_target,
)
from tpu_ray_tracer.parallel.multihost import (  # noqa: E402
    global_pixel_mesh, host_local_rows, initialize_distributed,
)
from tpu_ray_tracer.parallel.sharding import render_image_sharded  # noqa: E402
from tpu_ray_tracer.render.pipeline import RenderConfig  # noqa: E402
from tpu_ray_tracer.render.reference_cpu import render_image_np  # noqa: E402

initialize_distributed()
assert jax.process_count() == nproc, jax.process_count()
assert jax.device_count() == 2 * nproc

mesh = global_pixel_mesh()
scene = dataclasses.replace(
    trt.load_from_file(os.path.join(REPO, "scenes", "quadratic.yml")),
    width=32, height=16,
)
config = RenderConfig(geom_dtype="float32", polish_iters=2, chunk_px=None)
camera = trt.Camera(
    position=jnp.zeros(3, jnp.float32),
    yaw_deg=jnp.asarray(90.0, jnp.float32),
    pitch_deg=jnp.asarray(0.0, jnp.float32),
)

# --- sharded forward across BOTH processes, fused kernel per device
img = render_image_sharded(scene, camera, mesh, config, backend="pallas",
                           interpret=True)
full = np.asarray(multihost_utils.process_allgather(img, tiled=True))
golden = render_image_np(scene)
bad_frac = float((np.abs(full - golden).max(-1) > 2.0 / 255.0).mean())

# --- host-local row strip bookkeeping
start, n_rows = host_local_rows(scene.height, mesh)

# --- one distributed train step: grad psum crosses the process boundary
problem = InverseProblem(scene_template=scene, config=config)
params = extract_params(scene.astype(config.dtype))
params = {k: jnp.asarray(v) * 0.6 for k, v in params.items()}
optimizer = problem.optimizer()
opt_state = optimizer.init(params)
train_step = make_train_step(problem, mesh)
target_padded = pad_target(jnp.asarray(full, jnp.float32), mesh, scene.height)
new_params, opt_state, loss = train_step(params, opt_state, camera,
                                         target_padded)
jax.block_until_ready(new_params)
loss_val = float(loss)
moved = bool(any(
    float(jnp.max(jnp.abs(new_params[k] - params[k]))) > 0 for k in params
))

# --- checkpoint while distributed: fit() with a SHARED checkpoint path on
# every process. The save must be process-0-gated —
# ungated, both processes would race np.savez on one file. The spy counts
# local save invocations; the collective inside each train step serializes
# the loop across processes, so the count is race-free.
import tpu_ray_tracer.diff.inverse as inv  # noqa: E402

ckpt = os.path.join(outdir, "shared_ckpt.npz")
ckpt_writes = []
_orig_save = inv.save_checkpoint


def _spy_save(path, params, opt_state, step):
    ckpt_writes.append(step)
    _orig_save(path, params, opt_state, step)


inv.save_checkpoint = _spy_save
fit_params, fit_losses = inv.fit(
    problem, full, steps=2, mesh=mesh, log_every=0,
    checkpoint_path=ckpt, checkpoint_every=1,
)
inv.save_checkpoint = _orig_save
multihost_utils.sync_global_devices("ckpt_written")
ckpt_step = int(np.load(ckpt)["__step__"]) if os.path.exists(ckpt) else -1

with open(os.path.join(outdir, f"result_{pid}.json"), "w") as f:
    json.dump({
        "process_count": jax.process_count(),
        "device_count": jax.device_count(),
        "bad_frac": bad_frac,
        "row_start": start,
        "row_count": n_rows,
        "loss": loss_val,
        "moved": moved,
        "ckpt_writes": len(ckpt_writes),
        "ckpt_step": ckpt_step,
    }, f)
print(f"[worker {pid}] ok: bad_frac={bad_frac}, loss={loss_val:.3e}")

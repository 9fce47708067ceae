"""Shared pieces (no tests of its own) of the tests that hold the PyTorch
port against the JAX package: the same inputs, made with numpy from a
seed, go to both.

- ``load_jax_megarender``: a private copy of the JAX package's
  render/megarender.py. Importing that module the normal way raises
  (it reads ``os.environ`` without importing ``os``), so the copy is
  exec'd with ``os`` injected and never put into ``sys.modules``.
- ``k1_case``: one megakernel call's inputs for both packages.
- ``assert_states_close``: the flip-budgeted comparison of two path
  states.
- ``flip_gate``: the image gate of bench.py (non-flip RMSE and a budget
  of flip pixels);
- ``scene_accels``, ``port_camera``, ``port_lights``, ``check_image``:
  one scene on either backend for both packages, and the per-pixel image
  check of the wavefront tests.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

import complex_materials_renderer_tpu.render as jax_render_pkg
from complex_materials_renderer_tpu.accel.clusters import build_clusters as jax_build_clusters
from complex_materials_renderer_tpu.kernels import megakernel as jmk
from complex_materials_renderer_tpu.kernels.pallas_trace import device_cluster_grid as jax_device_grid
from complex_materials_renderer_tpu.ops.medium import MediaTable as JaxMediaTable
from complex_materials_renderer_tpu_torch.kernels import cluster_grid as tcg
from complex_materials_renderer_tpu_torch.kernels import megakernel as tmk
from complex_materials_renderer_tpu_torch.kernels import traverse
from complex_materials_renderer_tpu_torch.ops.camera import make_camera
from complex_materials_renderer_tpu_torch.render.hitinfo import make_lights, make_scene_arrays
from complex_materials_renderer_tpu_torch.scene.medium import MediaTable

from helpers import assemble, fixture_camera, fixture_lights, make_test_scene

FLIP_THRESHOLD = 1e-2


def load_jax_megarender():
    """The JAX ``render/megarender.py`` as a private module object."""
    path = os.path.join(os.path.dirname(jax_render_pkg.__file__), "megarender.py")
    spec = importlib.util.spec_from_file_location(
        "complex_materials_renderer_tpu.render._megarender_private", path
    )
    mod = importlib.util.module_from_spec(spec)
    mod.__dict__["os"] = os
    spec.loader.exec_module(mod)
    return mod


def flip_gate(img, ref, threshold=FLIP_THRESHOLD):
    """(non-flip RMSE, flip pixel count) of ``img`` against ``ref``."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    flip = np.abs(img - ref).max(-1) > threshold
    err2 = (img - ref) ** 2
    nonflip = float(np.sqrt(err2[~flip].mean())) if (~flip).any() else 0.0
    return nonflip, int(flip.sum())


def helper_scene(duplicate_shell=False):
    """The helpers scene (floor + medium box), optionally with every
    medium triangle duplicated in place (a coincident double shell)."""
    tris, mats, media = make_test_scene()
    if duplicate_shell:
        med = mats == 1
        tris = np.concatenate([tris, tris[med]])
        mats = np.concatenate([mats, mats[med]])
    return tris, mats, media


def grids(tris, mats, **build_kw):
    """(JAX DeviceClusterGrid, port DeviceClusterGrid on the CPU) of the
    same host build."""
    jgrid = jax_device_grid(jax_build_clusters(tris, mats, **build_kw))
    return jgrid, tcg.from_jax_arrays(jgrid)


def camera_state(lanes, seed, ld=False):
    """Numpy MegaState fields: camera rays of the fixture camera through
    jittered pixels of a 32-wide frame, random u32 rng words (over half of
    them >= 2^31) and, in ld mode, random pixel hashes."""
    rs = np.random.default_rng(seed)
    cam = fixture_camera()
    origin = np.asarray(cam.origin, np.float32)
    fwd, right, up = (np.asarray(v, np.float32) for v in (cam.forward, cam.right, cam.up))
    scale = np.float32(cam.fov_scale)
    w, h = 32, lanes // 32
    px = (np.arange(lanes) % w + rs.uniform(size=lanes)).astype(np.float32)
    py = (np.arange(lanes) // w + rs.uniform(size=lanes)).astype(np.float32)
    u = (2.0 * px - w) / h
    v = -(2.0 * py - h) / h
    d = u[:, None] * right + v[:, None] * up + scale * fwd
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    if ld:
        rng = rs.integers(0, 2**30, size=lanes, dtype=np.uint32)  # sample indices
        aux = rs.integers(0, 2**32, size=lanes, dtype=np.uint32)
    else:
        rng = rs.integers(0, 2**32, size=lanes, dtype=np.uint32)
        aux = np.zeros(lanes, np.uint32)
    return dict(
        org=np.tile(origin[None], (lanes, 1)),
        dir=d,
        thr=np.ones((lanes, 3), np.float32),
        rad=np.zeros((lanes, 3), np.float32),
        rng=rng,
        depth=np.zeros(lanes, np.int32),
        alive=np.ones(lanes, bool),
        aux=aux,
    )


def k1_case(lanes=1024, seed=0, duplicate_shell=False, media_mats=None, ld=False):
    """Inputs of one megakernel call for both packages:
    (jax grid, port grid, jax media9, jax misc, numpy state fields)."""
    from complex_materials_renderer_tpu.render.hitinfo import make_scene_arrays

    tris, mats, media = helper_scene(duplicate_shell)
    jgrid, tgrid = grids(tris, mats, cluster_size=8, media_mats=media_mats)
    scene = make_scene_arrays(tris, mats, media, 1.0, 1)
    media9 = jmk.pack_media(scene.media, scene.scale)
    misc = jmk.pack_misc(fixture_lights(), scene.world_lo, scene.world_hi)
    fields = camera_state(lanes, seed, ld=ld)
    return jgrid, tgrid, media9, misc, fields


def run_both(case, **kw):
    """Run JAX ``trace_paths_mega`` (interpreted) and the port's plain
    version on the same inputs; returns (jax fields, port fields) as numpy."""
    import jax.numpy as jnp

    jgrid, tgrid, media9, misc, f = case
    jstate = jmk.MegaState(
        org=jnp.asarray(f["org"]), dir=jnp.asarray(f["dir"]),
        thr=jnp.asarray(f["thr"]), rad=jnp.asarray(f["rad"]),
        rng=jnp.asarray(f["rng"]), depth=jnp.asarray(f["depth"]),
        alive=jnp.asarray(f["alive"]), aux=jnp.asarray(f["aux"]),
    )
    out_j = jmk.trace_paths_mega(jgrid, media9, misc, jstate, **kw)
    tstate = tmk.from_jax_arrays(**f)
    out_t = tmk.trace_paths_mega(
        tgrid, torch.from_numpy(np.array(media9)), torch.from_numpy(np.array(misc)),
        tstate, **kw,
    )
    return state_numpy(out_j), state_numpy(out_t)


def state_numpy(st):
    """MegaState fields (either package) as numpy, rng words as uint32."""
    out = {}
    for name in ("org", "dir", "thr", "rad", "rng", "depth", "alive"):
        v = getattr(st, name)
        v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out[name] = v
    out["rng"] = out["rng"].astype(np.int64) & 0xFFFFFFFF
    return out


def assert_states_close(a, b, flips_per_1024=2, atol=1e-5, rtol=0.0, org_atol=None):
    """rng, depth and alive equal on every lane but the flip lanes (those
    whose depth or alive differ), at most ``flips_per_1024`` of every 1024
    lanes; dir, thr and rad within ``atol`` (+ ``rtol``) elsewhere, org
    within ``org_atol`` (default ``atol``) (+ ``rtol``).
    Returns (flip lanes, worst float error)."""
    n = a["depth"].shape[0]
    flip = (a["depth"] != b["depth"]) | (a["alive"] != b["alive"])
    n_flip = int(flip.sum())
    assert n_flip <= flips_per_1024 * max(1, n // 1024), f"{n_flip} flip lanes of {n}"
    keep = ~flip
    np.testing.assert_array_equal(a["rng"][keep], b["rng"][keep])
    worst = 0.0
    for name in ("org", "dir", "thr", "rad"):
        tol = org_atol if (name == "org" and org_atol is not None) else atol
        np.testing.assert_allclose(b[name][keep], a[name][keep], atol=tol, rtol=rtol,
                                   err_msg=name)
        if keep.any():
            worst = max(worst, float(np.abs(b[name][keep] - a[name][keep]).max()))
    return n_flip, worst


# The K1 cases of test_torch_megakernel*.py: (name, k1_case arguments,
# trace_paths_mega arguments).
_K1 = dict(max_depth=8, rr_depth=4, nee_max_media=1)
K1_CASES = (
    ("parity", dict(lanes=1024, seed=0), _K1),
    ("counter, live_blocks", dict(lanes=2048, seed=1), dict(max_iters=1, live_blocks=1, **_K1)),
    ("ld", dict(lanes=1024, seed=2, ld=True), dict(ld=True, dim0=2, **_K1)),
    ("tir_kill + analytic_direct", dict(lanes=1024, seed=10),
     dict(tir_kill=True, analytic_direct=True, **_K1)),
    ("partitioned grid", dict(lanes=1024, seed=11, media_mats={1}), _K1),
    ("coincident shell", dict(lanes=1024, seed=12, duplicate_shell=True),
     dict(max_depth=6, rr_depth=3, nee_max_media=1)),
    ("ld, clipped dim base", dict(lanes=1024, seed=13, ld=True),
     dict(ld=True, dim0=5000, max_iters=2, **_K1)),
)


def scene_accels(tris, mats, media, backend, scale=1.0):
    """(JAX scene, JAX accel, port scene, port accel) of one scene on the
    ``bvh`` or ``cluster`` backend (JAX K3 interpreted, width 8)."""
    jscene, jbvh = assemble(tris, mats, JaxMediaTable(*media), scale=scale)
    tscene = make_scene_arrays(tris, mats, MediaTable(*media), scale, 1, device="cpu")
    if backend == "bvh":
        return jscene, jbvh, tscene, traverse.device_bvh_from_jax(jbvh)
    jgrid = jax_device_grid(jax_build_clusters(tris, mats, cluster_size=8), interpret=True)
    return jscene, jgrid, tscene, tcg.from_jax_arrays(jgrid)


def port_lights():
    """The port's counterpart of helpers.fixture_lights."""
    return make_lights((2.0, 4.0, 3.0), (0.8, 0.8, 0.6), 100.0)


def port_camera():
    """The port's counterpart of helpers.fixture_camera."""
    return make_camera((0.0, 1.5, 5.0), (0.0, 1.0, 0.0), 36.0)


def check_image(img, ref, max_flips):
    """Images equal within atol 1e-5 except at most ``max_flips`` flip
    pixels (|diff| > 1e-2)."""
    img = np.asarray(img, np.float64)
    diff = np.abs(img - ref).max(-1)
    flips = int((diff > 1e-2).sum())
    assert flips <= max_flips, flips
    keep = diff <= 1e-2
    np.testing.assert_allclose(img[keep], ref[keep], atol=1e-5)
    assert np.isfinite(img).all() and img.mean() > 0


def main():
    """Print, for every K1 case, the flip lanes and the worst error of each
    float field of the port's plain K1 against the JAX kernel on the CPU:
    the reading behind the tests' tolerances.
    Run from the repo root: JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_support.py"""
    torch.set_num_threads(1)
    for name, case_kw, kw in K1_CASES:
        a, b = run_both(k1_case(**case_kw), **kw)
        keep = ~((a["depth"] != b["depth"]) | (a["alive"] != b["alive"]))
        errs = {f: float(np.abs(a[f] - b[f])[keep].max()) for f in ("org", "dir", "thr", "rad")}
        print(f"{name}: flip lanes {int((~keep).sum())}, worst errors "
              + ", ".join(f"{f} {e:.3e}" for f, e in errs.items()), flush=True)


if __name__ == "__main__":
    main()

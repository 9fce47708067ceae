"""Kernel-against-plain tests of the PyTorch port that need a CUDA card.

They carry the ``gpu`` marker and skip where no card is present. This
file imports neither JAX nor the test helpers, so it also runs on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_gpu.py

Tolerance of the kernel against its plain version on the same card: rng,
depth and alive equal except on at most 1e-3 of the lanes (flip lanes,
where depth or alive differ), the float state within atol 1e-4 and rtol
1e-4 elsewhere (the smoke test's gate; on the card the two agree to the
bit in practice)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from complex_materials_renderer_tpu_torch.accel.clusters import build_clusters
from complex_materials_renderer_tpu_torch.config import RenderOptions
from complex_materials_renderer_tpu_torch.kernels import megakernel as mk
from complex_materials_renderer_tpu_torch.kernels.cluster_grid import device_cluster_grid
from complex_materials_renderer_tpu_torch.render.hitinfo import make_lights, make_scene_arrays
from complex_materials_renderer_tpu_torch.renderer import Renderer
from complex_materials_renderer_tpu_torch.scene import MediaTable, load_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card present")
    return torch.device("cuda")


def _box(c, h):
    x0, x1, y0, y1, z0, z1 = c[0] - h, c[0] + h, c[1] - h, c[1] + h, c[2] - h, c[2] + h
    quads = [
        ([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),
        ([x1, y0, z0], [x0, y0, z0], [x0, y1, z0], [x1, y1, z0]),
        ([x1, y0, z1], [x1, y0, z0], [x1, y1, z0], [x1, y1, z1]),
        ([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0]),
        ([x0, y1, z1], [x1, y1, z1], [x1, y1, z0], [x0, y1, z0]),
        ([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]),
    ]
    return [t for p in quads for t in ([p[0], p[1], p[2]], [p[0], p[2], p[3]])]


def _scene(device, duplicate_shell=False):
    """A floor (opaque) and a medium box, the shape of tests/helpers.py."""
    floor = [[[-10, 0, 10], [10, 0, 10], [10, 0, -10]], [[-10, 0, 10], [10, 0, -10], [-10, 0, -10]]]
    box = _box([0.0, 1.0, 0.0], 0.8)
    if duplicate_shell:
        box = box + box
    tris = np.asarray(floor + box, np.float32)
    mats = np.asarray([0, 0] + [1] * len(box), np.int32)
    media = MediaTable(
        mat_id=np.array([1], np.int32),
        sigma_s=np.array([[0.08, 0.08, 0.08]], np.float32),
        sigma_a=np.array([[0.02, 0.03, 0.04]], np.float32),
        g=np.array([[0.6, 0.6, 0.6]], np.float32),
        ior=np.array([1.33], np.float32),
    )
    scene = make_scene_arrays(tris, mats, media, 1.0, 1, device=device)
    grid = device_cluster_grid(build_clusters(tris, mats, cluster_size=8), device)
    lights = make_lights((2.0, 4.0, 3.0), (0.8, 0.8, 0.6), 100.0, device=device)
    return scene, grid, lights


def _state(n, device, seed, ld=False):
    rs = np.random.default_rng(seed)
    org = np.tile(np.array([[0.0, 1.5, 5.0]], np.float32), (n, 1))
    d = rs.normal(size=(n, 3)) * [0.3, 0.3, 1.0] - [0.0, 0.1, 1.0]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rng = rs.integers(0, 2**30 if ld else 2**32, n, dtype=np.uint32)
    aux = rs.integers(0, 2**32, n, dtype=np.uint32) if ld else np.zeros(n, np.uint32)
    return mk.from_jax_arrays(org, d, np.ones((n, 3), np.float32), np.zeros((n, 3), np.float32),
                              rng, np.zeros(n, np.int32), np.ones(n, bool), aux, device=device)


def _close(a, b):
    flip = (a.depth != b.depth) | (a.alive != b.alive)
    n = a.depth.shape[0]
    assert int(flip.sum()) <= 1e-3 * n
    keep = ~flip
    assert torch.equal(a.rng[keep], b.rng[keep])
    for f in ("org", "dir", "thr", "rad"):
        x, y = getattr(a, f)[keep], getattr(b, f)[keep]
        assert torch.isfinite(x).all()
        assert torch.all((x - y).abs() <= 1e-4 + 1e-4 * y.abs()), f


CASES = [
    ("parity", dict(nee_max_media=4)),
    ("parity nee 1", dict(nee_max_media=1)),
    ("parity nee 8", dict(nee_max_media=8)),
    ("counter one bounce", dict(nee_max_media=4, max_iters=1, live_blocks=3)),
    ("ld", dict(nee_max_media=4, ld=True, dim0=2)),
    ("tir kill analytic", dict(nee_max_media=4, tir_kill=True, analytic_direct=True)),
    ("shell", dict(nee_max_media=1, shell=True)),
]


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain(cuda, name, kw):
    kw = dict(kw)
    scene, grid, lights = _scene(cuda, duplicate_shell=kw.pop("shell", False))
    media9 = mk.pack_media(scene.media, scene.scale, device=cuda)
    misc = mk.pack_misc(lights, scene.world_lo, scene.world_hi, device=cuda)
    st = _state(4096, cuda, seed=len(name), ld=kw.get("ld", False))
    a = mk.MegaState(*(x.clone() for x in st))
    b = mk.MegaState(*(x.clone() for x in st))
    before = mk.trace_paths_mega.launches
    mk.trace_paths_mega(grid, media9, misc, a, max_depth=8, rr_depth=4, **kw)
    torch.cuda.synchronize()
    assert mk.trace_paths_mega.launches == before + 1
    mk.trace_paths_mega_plain(grid, media9, misc, b, max_depth=8, rr_depth=4, **kw)
    _close(a, b)
    if "live_blocks" in kw:
        lanes = kw["live_blocks"] * mk.BLOCK
        for f in ("org", "rad", "rng", "depth", "alive"):
            assert torch.equal(getattr(a, f)[lanes:], getattr(st, f)[lanes:])


def test_wrapper_refuses_bad_inputs(cuda):
    scene, grid, lights = _scene(cuda)
    media9 = mk.pack_media(scene.media, scene.scale, device=cuda)
    misc = mk.pack_misc(lights, scene.world_lo, scene.world_hi, device=cuda)
    st = _state(1024, cuda, seed=1)
    with pytest.raises(ValueError, match="nee-bound"):
        mk.trace_paths_mega(grid, media9, misc, st, nee_max_media=9)
    with pytest.raises(TypeError):
        mk.trace_paths_mega(grid, media9.double(), misc, st)
    bad = st._replace(org=st.org.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        mk.trace_paths_mega(grid, media9, misc, bad)
    with pytest.raises(ValueError, match="expected"):
        mk.trace_paths_mega(grid, media9.cpu(), misc, st)


def test_renderer_cuda_matches_cpu(cuda):
    obj = os.path.join(REPO, "scenes", "gembox.obj")
    kw = dict(width=48, height=32, num_samples=4, shard="none")
    scene = load_scene(obj, RenderOptions(obj_path=obj, **kw))
    opt = dataclasses.replace(scene.options, **kw)
    before = mk.trace_paths_mega.launches
    img_gpu = Renderer(scene, opt, device="cuda").render()
    assert mk.trace_paths_mega.launches > before
    img_cpu = Renderer(scene, opt, device="cpu").render()
    diff = np.abs(img_gpu - img_cpu).max(-1)
    assert int((diff > 1e-2).sum()) <= 2
    np.testing.assert_allclose(img_gpu[diff <= 1e-2], img_cpu[diff <= 1e-2], atol=1e-4)

"""The warp-box cull of K1 and K2 (kernels/composite.py
``warp_box_keep_plain``) against the compositing's plain versions, on the
CPU: the cull drops no (pixel, entry) pair that the walk takes as live, on
a random scene and on adversarial entries, and a walk and a replay that
skip the culled pairs give ``composite_fwd_plain``'s and
``composite_bwd_plain``'s results.

torch only (no JAX). ``adversarial_entries`` is also the input of the card
tests in tests/test_torch_kernels.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from splatformer_tpu_torch.kernels.composite import (  # noqa: E402
    PIXELS, PLAIN_CHUNK, TILE, USED_ROWS, composite_bwd_plain,
    composite_fwd_plain, pixel_box, warp_box_keep_plain)

THR = 1.0 / 255.0
MAX_ALPHA = 0.999
EPS_T = 1e-4


def scene_entries():
    """The port's own entries of a 4096-Gaussian scene under 2 orbit views
    at 64^2: (packed_t, tile_start, tiles_x, tiles_img)."""
    from splatformer_tpu_torch.data.synthetic import (orbit_cameras,
                                                      random_scene)
    from splatformer_tpu_torch.ops.render import prepare_entries
    from splatformer_tpu_torch.ops.types import RasterizeConfig
    scene = random_scene(np.random.default_rng(0), 4096, sh_degree=1,
                         device="cpu")
    e = prepare_entries(scene, orbit_cameras(2, 64, 64, device="cpu"),
                        RasterizeConfig())
    return e.packed_t, e.tile_start, 4, 16


def _sigma32(x, y, c0, c1, c2, px, py):
    """sigma at pixels (px, py) in float32, in the kernels' order."""
    dx = np.float32(x) - px
    dy = np.float32(y) - py
    return np.maximum(np.float32(0.5) * (c0 * dx * dx + c2 * dy * dy)
                      + c1 * dx * dy, np.float32(0.0))


def adversarial_entries(finite_only=False, seed=0):
    """Entries made to sit on the cull's edges, on one 32x32 view (2x2
    tiles), ~100 a tile: opacities tuned so that alpha at the tile's
    nearest pixel lies 0-4 float32 ulps either side of 1/255; conics with
    c1^2 within 1e-7 of c0 c2 (some turn non-definite in float32); centres
    on box edges, corners and half-pixels; and, unless ``finite_only``,
    non-definite and non-finite entries (which the cull must keep). Returns
    (packed_t, tile_start, tiles_x, tiles_img) on the CPU."""
    rng = np.random.default_rng(seed)
    f = np.float32
    tiles_x, n_tiles = 2, 4
    ys, xs = np.meshgrid(np.arange(TILE, dtype=f), np.arange(TILE, dtype=f),
                         indexing="ij")
    offsets = np.array([-0.5, 0.0, 3.0, 3.5, 4.0, 7.0, 7.5, 8.0, 11.5, 12.0,
                        15.0, 15.5, 16.0], f)
    cols, start = [], [0]
    for t in range(n_tiles):
        tx0, ty0 = f(TILE * (t % tiles_x)), f(TILE * (t // tiles_x))
        ents = []
        for i in range(96):
            if i % 3 == 0:   # on an edge, a corner or a half-pixel of a box
                x = tx0 + rng.choice(offsets)
                y = ty0 + rng.choice(offsets)
            else:
                x = tx0 + f(rng.uniform(-6.0, 22.0))
                y = ty0 + f(rng.uniform(-6.0, 22.0))
            c0, c2 = (f(np.exp(rng.uniform(np.log(0.02), np.log(2.0))))
                      for _ in range(2))
            rho = (rng.choice([-1, 1]) * (1 - 10.0 ** -rng.integers(1, 8))
                   if i % 4 == 1 else rng.uniform(-0.95, 0.95))
            c1 = f(rho * np.sqrt(float(c0) * float(c2)))
            sig = _sigma32(x, y, c0, c1, c2, tx0 + xs, ty0 + ys).min()
            op = f(THR) / np.exp(-sig, dtype=f)
            for _ in range(abs(k := int(rng.integers(-4, 5)))):
                op = np.nextafter(op, f(np.inf if k > 0 else 0.0))
            ents.append([x, y, c0, c1, c2, min(op, f(0.95)),
                         *rng.uniform(0, 1, 3)])
        bad = [(f(-0.1), f(0.0), f(0.3)), (f(0.3), f(0.0), f(0.0)),
               (f(0.2), f(0.5), f(0.3)), (f(0.3), f(0.0), f(-0.2))]
        if not finite_only:
            bad += [(f(np.nan), f(0.0), f(0.3)), (f(0.3), f(np.inf), f(0.3)),
                    (f(np.inf), f(0.0), f(0.3))]
        for c0, c1, c2 in bad:   # never culled
            ents.append([tx0 + f(rng.uniform(-8, 24)),
                         ty0 + f(rng.uniform(-8, 24)), c0, c1, c2, f(0.5),
                         *rng.uniform(0, 1, 3)])
        if not finite_only:
            ents.append([f(np.inf), ty0, f(0.3), f(0.0), f(0.3), f(0.5),
                         0.5, 0.5, 0.5])
            ents.append([tx0, ty0, f(0.3), f(0.0), f(0.3), f(np.inf),
                         0.5, 0.5, 0.5])
        order = rng.permutation(len(ents))
        cols += [ents[k] for k in order]
        start.append(len(cols))
    budget = -(-len(cols) // 128) * 128 + 128
    packed = np.zeros((16, budget), f)
    packed[:USED_ROWS, :len(cols)] = np.asarray(cols, f).T
    return (torch.from_numpy(packed), torch.tensor(start, dtype=torch.int32),
            tiles_x, n_tiles)


INPUTS = {"scene": scene_entries, "adversarial": adversarial_entries}


def _pixels(tile_start, tiles_x, tiles_img):
    num_tiles = tile_start.shape[0] - 1
    local = torch.arange(num_tiles) % tiles_img
    p = torch.arange(PIXELS)
    px = ((local % tiles_x) * TILE)[:, None] + (p % TILE)[None, :]
    py = (local // tiles_x * TILE)[:, None] + (p // TILE)[None, :]
    return px.float()[..., None], py.float()[..., None]


def _chunk(packed_t, tile_start, tiles_x, tiles_img, base, n):
    """Entries base .. base + n of every tile with sigma, exp and alpha at
    every pixel, in composite_fwd_plain's operations: (j, in_range, e,
    dx, dy, ex, raw, alpha), pixel-major (T, 256, C)."""
    start = tile_start[:-1].long()
    length = (tile_start[1:] - tile_start[:-1]).long()
    px, py = _pixels(tile_start, tiles_x, tiles_img)
    j = base + torch.arange(n)
    in_range = j[None, :] < length[:, None]
    idx = torch.where(in_range, start[:, None] + j[None, :], 0)
    e = packed_t[:USED_ROWS, idx]
    dx = e[0][:, None, :] - px
    dy = e[1][:, None, :] - py
    c0, c1, c2 = (e[k][:, None, :] for k in (2, 3, 4))
    sigma = torch.clamp(0.5 * (c0 * dx * dx + c2 * dy * dy) + c1 * dx * dy,
                        min=0.0)
    ex = torch.exp(-sigma)
    raw = e[5][:, None, :] * ex
    return j, in_range, e, dx, dy, ex, raw, torch.clamp(raw, max=MAX_ALPHA)


def _kept(keep, j):
    """(T, 256, C): each pixel's keep bit of entries j, from its box's."""
    return keep[:, :, j][:, pixel_box(), :]


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_cull_drops_no_live_pair(kind):
    """Every (pixel, entry) pair whose alpha reaches the threshold, over the
    whole range (not only the walked part), is kept by its pixel's box; and
    the cull is not vacuous: it drops most (scene) or many (adversarial)
    box-entries."""
    packed_t, tile_start, tiles_x, tiles_img = INPUTS[kind]()
    keep = warp_box_keep_plain(packed_t, tile_start, tiles_x, tiles_img, THR)
    length = (tile_start[1:] - tile_start[:-1]).long()
    live = culled_live = 0
    for base in range(0, keep.shape[2], PLAIN_CHUNK):
        n = min(PLAIN_CHUNK, keep.shape[2] - base)
        j, in_range, *_, alpha = _chunk(packed_t, tile_start, tiles_x,
                                        tiles_img, base, n)
        on = (alpha >= THR) & in_range[:, None, :]
        live += int(on.sum())
        culled_live += int((on & ~_kept(keep, j)).sum())
    kept_share = float(keep.sum()) / float(8 * length.sum())
    assert live > 0
    assert culled_live == 0
    assert kept_share < (0.5 if kind == "scene" else 0.9), kept_share


def test_cull_edges_of_adversarial_entries():
    """On the adversarial entries: the tuned opacities put alpha at the
    nearest pixel on both sides of the threshold; every non-definite or
    non-finite entry is kept in all 8 boxes; and where a box is culled, its
    largest alpha is below the threshold."""
    packed_t, tile_start, tiles_x, tiles_img = adversarial_entries()
    keep = warp_box_keep_plain(packed_t, tile_start, tiles_x, tiles_img, THR)
    n = keep.shape[2]
    j, in_range, e, *_, alpha = _chunk(packed_t, tile_start, tiles_x,
                                       tiles_img, 0, n)
    near = alpha.max(dim=1).values                               # (T, C)
    tuned = in_range & torch.isfinite(near) & ((near - THR).abs() < 1e-8)
    assert bool((tuned & (near >= THR)).any())
    assert bool((tuned & (near < THR)).any())
    c0, c1, c2 = e[2], e[3], e[4]
    odd = in_range & ~(torch.isfinite(e[:6]).all(dim=0) & (c0 > 0) & (c2 > 0)
                       & (c0 * c2 > c1 * c1))
    assert int(odd.sum()) >= 4 * 9
    assert bool(keep.permute(0, 2, 1)[odd].all())
    box_max = torch.stack([alpha[:, pixel_box() == w].max(dim=1).values
                           for w in range(8)], dim=1)            # (T, 8, C)
    culled = ~keep & in_range[:, None, :]
    assert bool(culled.any())
    assert bool((box_max[culled] < THR).all())


def culled_walk(packed_t, tile_start, tiles_x, tiles_img, keep):
    """K1's walk with the cull: a pixel evaluates only the entries its box
    keeps (a culled pair's alpha is poisoned with NaN, so it cannot be
    used) and adds each culled run to walked in one step."""
    num_tiles = tile_start.shape[0] - 1
    length = (tile_start[1:] - tile_start[:-1]).long()
    rgb = torch.zeros((num_tiles, PIXELS, 3))
    T = torch.ones((num_tiles, PIXELS))
    walked = torch.zeros((num_tiles, PIXELS), dtype=torch.int64)
    nxt = torch.zeros((num_tiles, PIXELS), dtype=torch.int64)
    done = torch.zeros((num_tiles, PIXELS), dtype=torch.bool)
    for base in range(0, keep.shape[2], PLAIN_CHUNK):
        n = min(PLAIN_CHUNK, keep.shape[2] - base)
        j, in_range, e, *_, alpha = _chunk(packed_t, tile_start, tiles_x,
                                           tiles_img, base, n)
        kept = _kept(keep, j) & in_range[:, None, :]
        alpha = torch.where(kept, alpha, float("nan"))
        for c in range(n):
            step = ~done & kept[..., c]
            walked += torch.where(step, base + c - nxt, 0)       # culled run
            a = alpha[..., c]
            next_T = T * (1.0 - a)
            ok = step & (a >= THR)
            cross = ok & (next_T <= EPS_T)
            comp = ok & ~cross
            vis = a * T
            col = e[6:9, :, c].T[:, None, :]
            rgb = torch.where(comp[..., None], rgb + vis[..., None] * col, rgb)
            T = torch.where(comp, next_T, T)
            walked += (step & ~cross).long()
            nxt = torch.where(step, base + c + 1, nxt)
            done |= cross
    walked += torch.where(done, 0, length[:, None] - nxt)        # last run
    return torch.cat([rgb, T[..., None]], dim=-1), walked.int()


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_culled_walk_matches_plain_forward(kind):
    """The walk that skips culled pairs gives composite_fwd_plain's out and
    walked bit for bit, and pixels do terminate."""
    args = INPUTS[kind]()
    keep = warp_box_keep_plain(*args, THR)
    out, walked = culled_walk(*args, keep)
    out_p, walked_p = composite_fwd_plain(*args, THR, MAX_ALPHA, EPS_T)
    assert torch.equal(walked, walked_p)
    assert torch.equal(out, out_p)
    length = (args[1][1:] - args[1][:-1]).long()
    assert bool((walked_p < length[:, None]).any())


def culled_replay(packed_t, tile_start, tiles_x, tiles_img, out, walked,
                  g_out, keep):
    """K2's replay with the cull: composite_bwd_plain's recurrences over the
    walked entries that each pixel's box keeps; each entry's values summed
    over the pixels of each box, then over the 8 boxes in order, as the
    kernel sums them."""
    num_tiles = tile_start.shape[0] - 1
    start = tile_start[:-1].long()
    d_packed = torch.zeros_like(packed_t)
    g0, g1, g2, g_t = g_out.unbind(-1)
    s_rem = g0 * out[..., 0] + g1 * out[..., 1] + g2 * out[..., 2]
    gt_term = g_t * out[..., 3]
    T = torch.ones((num_tiles, PIXELS))
    n_walk = walked.long()
    box = pixel_box()
    for base in range(0, int(n_walk.max()), PLAIN_CHUNK):
        n = min(PLAIN_CHUNK, int(n_walk.max()) - base)
        j, in_range, e, dx, dy, ex, raw, alpha = _chunk(
            packed_t, tile_start, tiles_x, tiles_img, base, n)
        live = ((alpha >= THR) & (j[None, None, :] < n_walk[:, :, None])
                & _kept(keep, j))
        gc = (g0[..., None] * e[6][:, None, :] + g1[..., None] * e[7][:, None, :]
              + g2[..., None] * e[8][:, None, :])
        da = torch.zeros_like(alpha)
        vis = torch.zeros_like(alpha)
        for c in range(n):
            a, on = alpha[..., c], live[..., c]
            v = a * T
            s_rem = torch.where(on, s_rem - gc[..., c] * v, s_rem)
            da[..., c] = torch.where(
                on, T * gc[..., c] - (s_rem + gt_term) / (1.0 - a), 0.0)
            vis[..., c] = torch.where(on, v, 0.0)
            T = torch.where(on, T * (1.0 - a), T)
        gate = live & (raw < MAX_ALPHA)
        dsig = torch.where(gate, -raw * da, 0.0)
        c0, c1, c2 = (e[k][:, None, :] for k in (2, 3, 4))
        rows = [dsig * (c0 * dx + c1 * dy), dsig * (c1 * dx + c2 * dy),
                0.5 * dsig * dx * dx, dsig * dx * dy, 0.5 * dsig * dy * dy,
                torch.where(gate, da * ex, 0.0), g0[..., None] * vis,
                g1[..., None] * vis, g2[..., None] * vis]
        sums = torch.zeros((USED_ROWS, num_tiles, n))
        for w in range(8):
            sums = sums + torch.stack([r[:, box == w].sum(dim=1)
                                       for r in rows])
        idx = torch.where(in_range, start[:, None] + j[None, :], 0)
        d_packed[:USED_ROWS, idx[in_range]] = sums[:, in_range]
    return d_packed


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_culled_replay_matches_plain_backward(kind):
    """The replay that skips culled pairs gives composite_bwd_plain's
    d_packed within 1e-6 of each row's largest magnitude (the sums over
    pixels run in the kernel's order, box by box); a seeded cotangent with
    a T channel. The adversarial entries are the finite ones: on the
    others the plain backward's products are NaN (0 * inf)."""
    args = (adversarial_entries(finite_only=True) if kind == "adversarial"
            else INPUTS[kind]())
    out, walked = composite_fwd_plain(*args, THR, MAX_ALPHA, EPS_T)
    g_out = torch.from_numpy(np.random.default_rng(3).normal(
        size=tuple(out.shape)).astype(np.float32))
    keep = warp_box_keep_plain(*args, THR)
    got = culled_replay(*args, out, walked, g_out, keep)
    want = composite_bwd_plain(*args, out, walked, g_out, THR, MAX_ALPHA)
    for r in range(USED_ROWS):
        scale = float(want[r].abs().max())
        assert scale > 0, r
        assert float((got[r] - want[r]).abs().max()) <= 1e-6 * scale, r
    assert not bool(got[USED_ROWS:].any())

"""The traffic generators: the same seed gives the same bytes, and every
seed gets the same multiset of shapes; the training cell's samples are
the port's loader's draws, with one layout for every seed."""

import numpy as np

from portbench.gen import images


def _pool(seed):
    return images.make_pool(seed, 12, "64x96,96x64,48x64", (2, 6), (8, 30))


def test_same_seed_same_bytes():
    a, b = _pool(2 ** 31 + 5), _pool(2 ** 31 + 5)
    assert [x["jpeg"] for x in a] == [x["jpeg"] for x in b]
    assert all(np.array_equal(x["boxes"], y["boxes"]) for x, y in zip(a, b))


def test_seeds_share_shapes_not_content():
    a, b = _pool(1), _pool(2)
    assert sorted(x["shape"] for x in a) == sorted(x["shape"] for x in b)
    assert [x["jpeg"] for x in a] != [x["jpeg"] for x in b]


def test_grouped_shares_shape_in_fours():
    pool = images.grouped(_pool(3), 4, 3)
    for g in range(0, len(pool), 4):
        assert len({x["shape"] for x in pool[g:g + 4]}) == 1


def test_layout_seed_fixes_faces_and_order_not_pixels():
    def pool(seed):
        return images.make_pool(seed, 12, "64x96,96x64,48x64", (2, 6),
                                (8, 30), layout_seed=3)
    a, b = pool(1), pool(2 ** 31 + 9)
    assert [x["shape"] for x in a] == [x["shape"] for x in b]
    assert all(np.array_equal(x["boxes"], y["boxes"]) for x, y in zip(a, b))
    assert [x["jpeg"] for x in a] != [x["jpeg"] for x in b]


def _train_samples(tmp_path, seed):
    import tiny
    from portbench import common, run
    from portbench.drivers import train_step
    folder = tiny.write(str(tmp_path))
    args = run.parse(["--workload", "tiny-train", "--seed", str(seed),
                      "--seconds", "1", "--workloads", folder])
    ctx = common.Context(args, None)
    return train_step, ctx, ctx.port_config()


def test_train_samples_follow_the_loaders_draws(tmp_path):
    """Each sample's scale, crop and extent are the loader's plan, and the
    gt boxes scaled and cropped here equal the plan's; every seed draws
    the same extents (so the same buckets)."""
    from smallhardface_tpu_torch.train.loader import RoIDataLoader
    ts, ctx, cfg = _train_samples(tmp_path, 2 ** 31 + 3)
    pool, iters = ts.samples(ctx, cfg)
    db = ts.roidb(pool, True)
    loader = RoIDataLoader(db)
    scale_seq = np.random.RandomState(int(cfg.RNG_SEED)).randint(
        0, len(cfg.TRAIN.SCALES.SHORT_SIDE), size=len(iters))
    plans = [[loader.plan_minibatch(int(s)) for _ in range(2)]
             for s in scale_seq]
    order = np.random.default_rng(ctx.seed + 2).permutation(len(iters))
    cropped = 0
    for k, it in enumerate(iters):
        for smp, p in zip(it, plans[order[k]]):
            assert smp["im_idx"] == p["im_idx"]
            assert (smp["height"], smp["width"]) == (p["height"],
                                                     p["width"])
            assert smp["crop"] == tuple(int(v) for v in p["crop"])
            assert smp["im_scale"] == p["im_scale"]
            np.testing.assert_array_equal(smp["gt_boxes"], p["gt_boxes"])
            cropped += p["crop"] != (0, 0)
    assert cropped > 0
    ts2, ctx2, cfg2 = _train_samples(tmp_path, 7)
    _, iters2 = ts2.samples(ctx2, cfg2)
    extents = sorted((s["height"], s["width"]) for it in iters for s in it)
    assert extents == sorted((s["height"], s["width"])
                             for it in iters2 for s in it)

"""A pool of WIDER-like JPEG images with glyph faces, from a seed.

Copies, changed as noted:

- ``_stamp_face`` is ``scripts/synth_wider.py`` :31-44 (the face glyph: a
  bright panel, a dark border, two dark eye dots), stamped on all three
  channels of a colour image.
- ``background`` is ``smallhardface_tpu_torch/tools/pyramid_time.py``
  :57-64 (``synthetic_image``: a blocky low-frequency colour field and
  noise), drawn from a ``numpy.random.Generator``.

Every seed gets the same multiset of image shapes (WIDER's three common
ones at width 1024) and the same face-count and face-size distributions;
the seed draws the content, the faces' places and the order. Given a
``layout_seed``, that seed draws the faces and the order instead, so that
every seed shares one layout and draws only the pixels.
"""

from __future__ import annotations

import numpy as np

SHAPES = {"768x1024": (768, 1024), "1024x768": (1024, 768),
          "683x1024": (683, 1024)}


def _stamp_face(img, x1, y1, size):
    x2, y2 = x1 + size, y1 + size
    img[y1:y2, x1:x2] = 230
    b = max(2, size // 12)
    img[y1:y1 + b, x1:x2] = 25
    img[y2 - b:y2, x1:x2] = 25
    img[y1:y2, x1:x1 + b] = 25
    img[y1:y2, x2 - b:x2] = 25
    ey = y1 + size // 3
    r = max(2, size // 10)
    for ex in (x1 + size // 3, x1 + 2 * size // 3):
        img[ey - r:ey + r, ex - r:ex + r] = 40


def background(h, w, rng):
    low = rng.integers(0, 256, (h // 32 + 2, w // 32 + 2, 3)).astype(
        np.float32)
    field = np.kron(low, np.ones((32, 32, 1), np.float32))[:h, :w]
    noise = rng.standard_normal((h, w, 3), dtype=np.float32) * 20
    return np.clip(field + noise, 0, 255).astype(np.uint8)


def shape_list(n, shapes):
    """n image shapes spread over ``shapes`` in fixed counts, each count a
    multiple of 4 where n allows (so that same-shape groups of four fill)."""
    names = [s.strip() for s in shapes.split(",")]
    k = len(names)
    base = (n // (4 * k)) * 4
    counts = [base] * k
    left = n - base * k
    i = 0
    while left > 0:
        step = min(4, left)
        counts[i % k] += step
        left -= step
        i += 1
    return [SHAPES[nm] if nm in SHAPES else tuple(
        int(v) for v in nm.split("x")) for nm, c in zip(names, counts)
        for _ in range(c)]


def faces(rng, h, w, lo, hi, size_lo, size_hi):
    """Face boxes (F, 4) [x1, y1, x2, y2]: a count in [lo, hi] and sizes in
    [size_lo, size_hi] px, both heavy-tailed (many small, few large)."""
    n = lo + int((hi - lo) * rng.random() ** 2)
    boxes = []
    for _ in range(n):
        size = int(size_lo * (size_hi / size_lo) ** (rng.random() ** 1.5))
        size = min(size, h - 2, w - 2)
        x1 = int(rng.integers(0, w - size))
        y1 = int(rng.integers(0, h - size))
        boxes.append([x1, y1, x1 + size, y1 + size])
    return np.asarray(boxes, np.float32).reshape(-1, 4)


def make_pool(seed, n, shapes, face_range, size_range, quality=95,
              layout_seed=None):
    """n images: [{"shape", "jpeg" bytes, "image" BGR uint8 as decoded,
    "boxes" (F, 4)}], in the seed's order (the layout seed's, if given)."""
    import cv2
    rng = np.random.default_rng(seed)
    layout = rng if layout_seed is None else np.random.default_rng(
        layout_seed)
    shape_of = shape_list(n, shapes)
    pool = []
    for h, w in shape_of:
        img = background(h, w, rng)
        boxes = faces(layout, h, w, *face_range, *size_range)
        for x1, y1, x2, y2 in boxes.astype(int):
            _stamp_face(img, x1, y1, x2 - x1)
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY,
                                             quality])
        if not ok:
            raise RuntimeError("JPEG encoding failed")
        jpeg = buf.tobytes()
        pool.append({"shape": (h, w), "jpeg": jpeg, "boxes": boxes,
                     "image": cv2.imdecode(np.frombuffer(jpeg, np.uint8),
                                           cv2.IMREAD_COLOR)})
    order = layout.permutation(n)
    return [pool[i] for i in order]


def grouped(pool, size, seed):
    """The pool reordered so that every ``size`` consecutive images share
    a shape, the groups in the seed's order."""
    by_shape = {}
    for item in pool:
        by_shape.setdefault(item["shape"], []).append(item)
    groups = [items[i:i + size] for items in by_shape.values()
              for i in range(0, len(items), size)]
    order = np.random.default_rng(seed).permutation(len(groups))
    return [it for g in order for it in groups[g]]


def parse_range(text):
    lo, hi = (int(v) for v in str(text).split("-"))
    return lo, hi

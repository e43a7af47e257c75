"""What the tile kernels' design constants buy on the card, and where the
tile order stops paying.

Builds copies of illuminant_tpu_torch/csrc/tile_raster.cu with one
constant changed (into build/tile_study/, one nvcc each, all started
together) and times K11a (`composite_over_tiles`) and K11b
(`sprite_accumulate`) of each copy on the same inputs, in turns (the
build, then each copy, then back), with the build's image required bit
for bit from every copy: the constants change which block runs what and
when, not any pixel's order. Inputs: `chip_smoke.steady_sprites` through
the sprite routes, at the sprite cells' 1080 x 1920 frame with 32-px
tiles and at other frame and tile sizes (the ring scaled with the
frame), the 8-px tiles with the quad profile (the leaf sprite needs an
apron of 9).

  * kOrderSpan (tiles a thread scans to order the tiles longest list
    first; screen order above): the build (16), always ordered, always
    screen order; at every case;
  * kAhead (chunks of records in flight) 3, kStageFloats (chunk size)
    8192 and 2048: at the cell's frame only.

Run from the repository root on a CUDA card:

    python3 tools/torch_tile_study.py

One JSON line a case (ms of each copy, the fastest of its turns) and the
card's name and power limit. Exits 2 without a card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# name -> (the source's line, its replacement); None: the build.
VARIANTS = {
    "build": None,
    "ordered": ("constexpr int kOrderSpan = 16;",
                "constexpr int kOrderSpan = 1 << 20;"),
    "screen": ("constexpr int kOrderSpan = 16;",
               "constexpr int kOrderSpan = 0;"),
    "ahead_3": ("constexpr int kAhead = 2;", "constexpr int kAhead = 3;"),
    "chunk_x2": ("constexpr int kStageFloats = 4096;",
                 "constexpr int kStageFloats = 8192;"),
    "chunk_half": ("constexpr int kStageFloats = 4096;",
                   "constexpr int kStageFloats = 2048;"),
}
ORDER = ("build", "ordered", "screen")
# (case, height, width, tile, particles, sprite route, variants timed)
CASES = [
    ("1080p_t32", 1080, 1920, 32, 1 << 17, True, tuple(VARIANTS)),
    ("1440p_t32", 1440, 2560, 32, 233017, True, ORDER),
    ("4k_t32", 2160, 3840, 32, 1 << 19, True, ORDER),
    ("1080p_t24", 1080, 1920, 24, 1 << 17, True, ORDER),
    ("720p_t16", 720, 1280, 16, 58254, True, ORDER),
    ("1080p_t16", 1080, 1920, 16, 1 << 17, True, ORDER),
    ("1080p_t12", 1080, 1920, 12, 1 << 17, True, ORDER),
    ("1080p_t8", 1080, 1920, 8, 1 << 17, False, ORDER),
]
REPS = 20


def build_all(tk):
    """Each variant's library -> name: path."""
    out_dir = ROOT / "build" / "tile_study"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = tk._SOURCE.read_text()

    def make(name):
        if VARIANTS[name] is None:
            return name, tk.build()
        old, new = VARIANTS[name]
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in the source")
        source = out_dir / f"{name}.cu"
        source.write_text(text.replace(old, new))
        lib = out_dir / f"lib{name}.so"
        proc = subprocess.run([tk._nvcc(), *tk.NVCC_FLAGS, "-o", str(lib),
                               str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n"
                               + proc.stdout + proc.stderr)
        return name, lib

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(pool.map(make, VARIANTS))


def load(tk, path):
    """The wrappers' library from `path`, loaded as `tk._library` loads
    the build's."""
    saved = tk._LIBRARY, tk._lib
    tk._LIBRARY, tk._lib = path, None
    try:
        return tk._library()
    finally:
        tk._LIBRARY, tk._lib = saved


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tile_study: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from illuminant_tpu_torch.raster import sprites, tiled
    from illuminant_tpu_torch.raster import tile_kernel as tk

    libs = {name: load(tk, path) for name, path in build_all(tk).items()}
    table = cs.sprite_appearance().sprite_table("cuda")
    card = cs.card_line()
    for case, h, w, t, n, sprite, names in CASES:
        x, y, color, size, live, rot = cs.steady_sprites("cuda", height=h,
                                                         width=w, n=n)
        cfg = tiled.TiledRasterConfig(height=h, width=w, tile=t,
                                      apron=min(9, t))
        bg = cs.lit_floor(h, w, "cuda")
        tk._lib = libs["build"]
        calls = {}
        if sprite:
            with cs.KernelInputs("composite_over_tiles") as spy:
                sprites.rasterize_sprites_alpha(cfg, table, x, y, color, size,
                                                live, rotation=rot,
                                                background=bg)
            calls["composite"] = ("composite_over_tiles", spy.args)
            if t == 32:
                calls["composite_hot"] = ("composite_over_tiles",
                                          cs.hottest_tile(spy.args))
            with cs.KernelInputs("sprite_accumulate") as spy:
                sprites.rasterize_sprites(cfg, table, x, y, color, size, live,
                                          rotation=rot)
            calls["accumulate"] = ("sprite_accumulate", spy.args)
        if t == 32 or not sprite:
            with cs.KernelInputs("composite_over_tiles") as spy:
                tiled.rasterize_tiled_alpha(
                    dataclasses.replace(cfg, kernel="quad"), x, y, color,
                    size, live, background=bg)
            calls["composite_quad"] = ("composite_over_tiles", spy.args)
        gy, gx = cfg.grid
        row = dict(case=case, height=h, width=w, tile=t, tiles=gy * gx,
                   threads=(t * t // 4 + 31) // 32 * 32, particles=n,
                   card=card)
        for key, (fname, args) in calls.items():
            fn = getattr(tk, fname)
            tk._lib = libs["build"]
            base = fn(*args)
            turns = {name: [] for name in names}
            for name in names + names[::-1]:
                tk._lib = libs[name]
                if not torch.equal(fn(*args), base):
                    raise AssertionError(f"{case} {key}: {name} changed the "
                                         "image")
                turns[name].append(cs.device_ms(lambda: fn(*args), REPS))
            for name, ms in turns.items():
                row[f"{key}_{name}_ms"] = round(min(ms), 4)
        tk._lib = libs["build"]
        print(json.dumps(row), flush=True)
        del calls, bg
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Render configuration — the reference's scattered compile-time constants
(``PPP_TAG``, ``BLOCK_SIZE``, draw distance 400, background (240,130,0),
``min_node_size``, light/Phong literals; see SURVEY.md §5 "Config") made into
one runtime dataclass. Fields that shape compiled code (resolution, tiling,
method) are static; physical quantities live in the scene/camera pytrees so
they stay differentiable.
"""

from __future__ import annotations

import dataclasses

from .dtypes import (DEFAULT_BACKGROUND_RGB, DEFAULT_DRAW_DISTANCE,
                     MT_EPSILON)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # Ray termination distance (Camera.cpp:70 / Trixel.cu:47 hardcode 400).
    draw_distance: float = DEFAULT_DRAW_DISTANCE
    # Miss-pixel fill color (Camera.cpp:72).
    background_rgb: tuple[int, int, int] = DEFAULT_BACKGROUND_RGB
    # MT acceptance epsilon (vector.cuh:10-13).
    eps: float = MT_EPSILON
    # Intersection backend: "brute" (oracle), "fixed" (matmul-form brute),
    # "bin" (screen-space binning + per-tile kernel, the main path),
    # "grid" (frustum-culled KD clusters), "raster", "kd".
    method: str = "fixed"
    # Triangle chunk for the brute paths (bounds R x chunk memory).
    chunk: int = 2048
    # --- cluster path (method="grid") ---
    # Triangles per spatial leaf cluster (KD build stops here; the
    # reference uses min_node_size=1, Trixel.h:80 — the cluster path wants
    # wide leaves and dense per-leaf MT).
    leaf_size: int = 128
    # Ray-tile edge lengths (pixels): tiles are the unit of culling for the
    # bin and grid paths.
    tile_h: int = 16
    tile_w: int = 32
    # Max candidate clusters per tile after culling (static shape bound).
    max_candidates: int = 48
    # Telemetry: method="bin" intersect_binned returns (Hit, stats).
    with_stats: bool = False
    # --- screen-space binning path (method="bin", accel/binning.py) ---
    # Bin kernel entries per inner-loop step (ops/pallas/bin_intersect.py;
    # a power of two, the entry table is padded to a multiple of it). The
    # default is the fastest of a sweep on an H100 at dragon-class size
    # (PERF.md).
    bin_chunk: int = 16
    # Static entry capacity = bin_e_factor * num_triangles + 8192 (each
    # triangle bins to every tile its projected bbox overlaps; overflow is
    # counted in stats and means dropped geometry — raise the factor).
    # The prepass sort+gathers scale with this static cap, so keep it
    # tight — bin_escalate re-bins at 2x when a scene/camera overflows it.
    bin_e_factor: float = 1.2
    # Capacity self-healing: when the entry table overflows (dropped
    # geometry), re-bin at 2x e_cap under lax.cond (runtime cost only on
    # the overflowing frame; the reference never drops geometry,
    # Trixel.cu:70-169). Residual overflow past 2x is still reported.
    bin_escalate: bool = True
    # Cull triangles whose plane faces away from the (shared) primary-ray
    # origin before binning (accel/binning.py). Exact for closed,
    # consistently-wound surfaces viewed from outside (a back-side hit is
    # occluded by a nearer front face) but for rays through the hairline
    # gaps the MT epsilon leaves along edges; halves the entry table on
    # such scenes. OFF by default: the reference's MT is two-sided
    # (|det|, Trixel.cu:101-126) and open meshes can expose back faces.
    # bench.py enables it for the closed procgen scenes and validates
    # full-image agreement against the two-sided oracle.
    backface_cull: bool = False
    # --- scatter-min rasterization path (method="raster", accel/raster.py)
    # Max projected-bbox span (pixels) handled by the per-triangle candidate
    # grid; triangles spanning more (or crossing the camera plane) go to the
    # dense overflow pass below. Cost scales with span^2 * num_tris.
    raster_span: int = 4
    # Static capacity of the overflow pass (0 disables it); overflow beyond
    # the cap is counted in stats — validation fails loudly, never silent.
    raster_ovf_cap: int = 512

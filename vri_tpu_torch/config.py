# Copy of vri_tpu/config.py for the port; besides the imports it drops
# RenderConfig's TPU knobs, which nothing in the port reads (tile_h,
# tile_w, tri_chunk, bin_capacity, coarse_bin, supersample, dtype).
"""Runtime configuration system.

The reference hardcodes everything at compile time: window size
(Source/Include/RenderContext.h:7-9), host pool limits (Include/Common.h:7-8),
cascade count + voxel sizes (Source/RenderPass.cpp:433-434,493-508), Brixelizer
tuning (RenderPass.cpp:927-930) and bindless table capacity 4096
(ResourceRegistry.cpp:25-34).  Here all of those become dataclass fields with
per-scene overrides, because on TPU these constants are *shape* parameters that
feed straight into jit static arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class SceneLimits:
    """Static capacity bounds for the packed scene arrays.

    The TPU build needs static shapes: every pool is padded to a fixed
    capacity, mirroring (but widening) the reference's caps — bindless tables
    of 4096 entries (ResourceRegistry.cpp:25-34) and 16+16-bit visibility
    packing (Shaders/Source/Visibility.hlsl:21-22).  We use 32-bit instance and
    primitive ids throughout, so these are memory caps, not format caps.
    """

    max_instances: int = 4096        # draw items / DrawItemMetaData entries
    max_materials: int = 4096        # matches the reference's bindless table
                                     # (ResourceRegistry.cpp:25-34); packed
                                     # pools size to the live count, so the
                                     # cap costs nothing until used
    max_vertices: int = 1 << 20      # packed position pool
    max_faces: int = 1 << 20         # packed triangle pool
    texture_res: int = 256           # unified texture array resolution
    # Padding quantum for pool shapes (lane width friendly).
    pad: int = 128

    def padded_vertices(self, n: int) -> int:
        return min(_round_up(max(n, 1), self.pad), self.max_vertices)

    def padded_faces(self, n: int) -> int:
        return min(_round_up(max(n, 1), self.pad), self.max_faces)


@dataclasses.dataclass(frozen=True)
class SDFConfig:
    """Sparse-brick SDF cascade ("Brixelizer-style") configuration.

    Mirrors the reference data model: up to 8 cascades with voxel size
    0.01*(1+i)*meshUnitSize (RenderPass.cpp:493-508), 64^3 cascade brick maps,
    8^3-voxel bricks stored in a shared atlas, <=2^18 bricks
    (ffx_brixelizer_host_gpu_shared.h:30,35,41,49).  The TPU build stores the
    brick atlas as a (max_bricks, 8, 8, 8) array — the structured equivalent of
    the reference's 512^3 R8 atlas — and keeps per-cascade occupancy in dense
    64^3 int32 maps (the "brick map").
    """

    num_cascades: int = 8
    cascade_resolution: int = 64      # voxels per cascade edge
    brick_size: int = 8               # voxels per brick edge (fixed by design)
    max_bricks: int = 1 << 18         # atlas capacity (reference: 2^18,
                                      # ffx_brixelizer_host_gpu_shared.h:35)
    base_voxel_size: float = 0.02     # cascade i voxel = base * (1 + i)
    # Truncation distance, in voxels, beyond which distance saturates to 1.0.
    truncation_voxels: float = 4.0
    # Sphere-march tuning (reference trace: <=8 steps per brick, 32 cascades
    # iterations cap — ffx_brixelizer_trace_ops.h:128,220-256).
    march_max_steps: int = 96
    march_epsilon: float = 1.0        # hit threshold, in brick texels
    march_min_step: float = 0.5       # minimum advance, in brick texels
    # lightloop step budgets (shadow rays, GI gather rays).  The march is a
    # lock-step while_loop: cost scales with the budget, not the average
    # ray; chebyshev empty-space skipping makes small budgets reach far.
    shadow_steps: int = 20
    gi_steps: int = 28
    # GI gather rays stop at this fraction of the coarsest cascade extent
    gi_range_factor: float = 0.5
    # direct shadows from the baked per-brick visibility (one gather, no
    # per-pixel shadow march; shadow edges quantize to the voxel size)
    cached_shadows: bool = False
    # two-stage ray compaction in the trilinear march loop (survivors
    # continue in a quarter-width buffer; exactness-preserving cleanup
    # loop); the march kernel refills its lanes and ignores it
    compact_march: bool = False
    # persistent-lane streaming march kernel: each (8,128) lane owns a
    # queue of rays and refills itself in-kernel when its ray finishes,
    # so a block never pays idle lock-step for its slowest lane.
    # Bit-exact vs the block kernel; 3.7x faster on the production GI
    # ray set (28.7 -> 7.8 ms at 540p, tools/micro_stream.py).  Falls
    # back to the block kernel below ~32k rays.
    stream_march: bool = True
    # march direct-light shadow rays on a subsampled pixel grid and
    # upsample the visibility factors (N.L + falloff stay full-rate);
    # shadow edges quantize by the factor.  1 = full-rate.
    shadow_scale: int = 1
    # nearest-texel (1-element-gather) sampling for occlusion/GI rays:
    # ~3x cheaper march steps at the cost of shadows fattening by up to
    # ~2 texels on grazing rays
    approx_occlusion: bool = False
    # Pallas march kernel for the approximate tier on TPU (voxel-precision
    # hits from VMEM-resident coarse-cell tables; see ops/march_kernel.py)
    kernel_march: bool = True
    # store the brick atlas as uint8 (the reference's R8_UNORM atlas,
    # RenderPass.cpp:299-302): 4x less HBM for a ~0.4% distance quantization.
    # On by default — 2^18 bricks x 512 texels at f32 would be 537 MB where
    # the reference's R8 layout costs 134 MB
    atlas_u8: bool = True
    max_triangles_per_brick: int = 64
    # Cell-binned builder (ops/sdf_build.py): per-cell triangle reference
    # list capacity and the per-cascade large-triangle list capacity —
    # the TPU analog of Brixelizer's bounded reference arrays
    # (maxBricksPerBake / triangle references, RenderPass.cpp:927-930).
    cell_list_cap: int = 64
    global_list_cap: int = 128
    # Bounded incremental updates (update_cascades): capacity of the
    # compacted dirty-cell and dirty-brick index arrays per update; updates
    # touching more fall back to a full rebuild.  These are STATIC shapes —
    # the emit re-runs over the whole padded capacity, so the caps set the
    # update's cost floor, not just its ceiling.
    update_cell_cap: int = 1024
    # Incremental radiance bake (animated frames): capacity of the
    # compacted re-bake set (payload-dirty ∪ shadow-segment-dirty bricks);
    # overflow falls back to the full bake, counted via needs_full
    bake_brick_cap: int = 32768
    # 8192: the round-4 exact emission completes occupancy that glob
    # saturation used to hide, so a small prop's truncation-reach dirty
    # region re-emits ~4.2k bricks on the kitchen stage (was silently
    # smaller before)
    update_brick_cap: int = 8192
    update_tri_cap: int = 4096

    @classmethod
    def preset(cls, name: str) -> "SDFConfig":
        """Named presets: 'reference' mirrors the reference's scale
        (8 cascades, 64^3); 'room' suits interior scenes a few meters
        across; 'tiny' keeps CPU tests fast."""
        if name == "reference":
            return cls()
        if name == "room":
            # list caps sized so the kitchen-stress bench scene builds
            # with ZERO dropped refs (the defaults saturated the glob
            # list at coarse cascades and a few dense cells — counted in
            # BuildState.list_overflow, but a saturated list is silently
            # degraded SDF quality and blocks bounded updates)
            # max_bricks 2^18 (the reference's own cap): the round-4
            # exact emission exposed ~200k-brick true occupancy demand
            # on the kitchen stage that glob-list saturation had been
            # hiding (~101k built before)
            return cls(num_cascades=6, cascade_resolution=64,
                       base_voxel_size=0.05, max_bricks=1 << 18,
                       max_triangles_per_brick=32, atlas_u8=True,
                       approx_occlusion=True, shadow_scale=2,
                       cell_list_cap=128, global_list_cap=512)
        if name == "tiny":
            return cls(num_cascades=2, cascade_resolution=16,
                       base_voxel_size=0.15, max_bricks=8192,
                       truncation_voxels=3.0, max_triangles_per_brick=16,
                       march_max_steps=64)
        raise ValueError(f"unknown SDF preset {name!r}")

    @property
    def bricks_per_axis(self) -> int:
        return self.cascade_resolution // self.brick_size

    def voxel_size(self, cascade: int) -> float:
        return self.base_voxel_size * (1.0 + cascade)

    def cascade_extent(self, cascade: int) -> float:
        """World-space edge length of one cascade."""
        return self.voxel_size(cascade) * self.cascade_resolution


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Top-level frame configuration (reference: fixed 1920x1080 swapchain,
    RenderContext.h:7-8; debug mode dropdowns, Include/RenderPass.h:36-45)."""

    width: int = 1920
    height: int = 1080
    # meshoptimizer-style preprocessing: weld duplicate vertices at sync
    # (the pass the reference vendors but never calls, RenderPass.cpp:1017)
    dedup_vertices: bool = False
    # Host-side sync worker threads for the pure per-prim prepare phase
    # (triangulation, vertex dedup, primvar expansion, texture decode) —
    # the TPU-native analog of the reference's TBB-parallel resource
    # commit + jthread async scene load (ResourceRegistry.cpp,
    # Main.cpp).  numpy / ctypes / PIL all release the GIL, so plain
    # threads scale; registry mutation stays serial and deterministic.
    # 0 = auto (min(8, cpu_count)); 1 = fully serial.
    sync_workers: int = 0
    # Discrete LOD chains (ops/lod.py + native QEM simplifier): each mesh
    # packs `lod_levels` decimated levels (triangle budget ratio
    # `lod_ratio` per level) alongside its full geometry; per frame, each
    # instance renders the coarsest level whose geometric deviation
    # projects below `lod_tau` pixels.  The honest fix for sub-pixel
    # triangle storms at scale (the reference rasterizes full-rate
    # geometry always and would need the same, RenderPass.cpp:642-664).
    # 0 = off.  Only primary visibility consumes LOD; the SDF build, BVH
    # and brute reference paths always see the full-rate geometry.
    lod_levels: int = 0
    lod_ratio: float = 0.25
    lod_min_faces: int = 256          # meshes below this stay single-level
    lod_tau: float = 0.75             # screen-space error budget, pixels
    # Treat every mesh as two-sided, ignoring authored doubleSided — the
    # reference's behavior (VK_CULL_MODE_NONE, Common.cpp:333).  Default
    # follows the USD spec instead: meshes are single-sided unless they
    # author doubleSided=true, and single-sided backfaces cull.
    force_double_sided: bool = False
    limits: SceneLimits = dataclasses.field(default_factory=SceneLimits)
    sdf: SDFConfig = dataclasses.field(default_factory=SDFConfig)

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.height, self.width)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# Debug / resolve modes, mirroring the reference's DebugMode enum
# (Include/RenderPass.h:36-45) and Brixelizer debug output modes
# (ffx_brixelizer_host_gpu_shared.h:86-93).
class DebugMode:
    NONE = 0
    MESH_ID = 1
    PRIM_ID = 2
    BARYCENTRIC = 3
    DEPTH = 4
    ALBEDO = 5
    NORMAL = 6
    SDF_DISTANCE = 7
    SDF_UVW = 8
    SDF_ITERATIONS = 9
    SDF_GRAD = 10
    SDF_BRICK_ID = 11
    SDF_CASCADE_ID = 12

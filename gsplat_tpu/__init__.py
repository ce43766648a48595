"""gsplat_tpu — a differentiable 3D Gaussian-splat rendering framework.

Built from scratch in JAX/Pallas with the capabilities of the reference
Houdini HDK/GLSL viewport plugin (rubendhz/houdini-gsplat-renderer, mounted at
/root/reference): EWA-projected screen-space Gaussians, SH color (deg 0-3),
global depth sort, tile binning, front-to-back alpha compositing — plus the
training / distribution stack the reference lacks (autodiff to all splat
parameters, multi-host sharding, checkpointing).

See SURVEY.md for the structural analysis of the reference this was built to.
"""

from .version import __version__
from .models.camera import Camera, make_camera, look_at, perspective
from .models.splats import GaussianSplats, make_splats, random_splats, trained_like_splats, to_numpy_dict
from .utils.config import RenderConfig
from .ops.binning import RenderStats, report_stats
from .ops.projection import ProjectedSplats, project_splats
from .ops.rasterize_ref import render_reference
from .ops.rasterize_tiles import depth_order, render_tiles
from .ops.wireframe import render_wire_over, render_wireframe
from .render import measure_pairs, render, render_pallas, tune_pair_budget
from .scene import SceneRegistry
from .io.ply import load_ply, save_ply
from .io.attributes import splats_from_attributes
from .io.json_io import load_json, save_json
from .ops.queries import RayHit, intersect_ray_bbox, intersect_rays_bbox

__all__ = [
    "render",
    "render_pallas",
    "measure_pairs",
    "tune_pair_budget",
    "render_tiles",
    "render_reference",
    "render_wireframe",
    "render_wire_over",
    "__version__",
    "Camera",
    "make_camera",
    "look_at",
    "perspective",
    "GaussianSplats",
    "make_splats",
    "random_splats",
    "to_numpy_dict",
    "RenderConfig",
    "ProjectedSplats",
    "project_splats",
    "depth_order",
    "SceneRegistry",
    "load_ply",
    "save_ply",
    "splats_from_attributes",
    "load_json",
    "save_json",
    "RayHit",
    "intersect_ray_bbox",
    "intersect_rays_bbox",
]

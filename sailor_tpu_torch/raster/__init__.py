"""Triangle setup, binning, visibility raster and resolve."""

from sailor_tpu_torch.raster import interpolate, setup, tile_raster
from sailor_tpu_torch.raster.pipeline import rasterize

__all__ = ["setup", "tile_raster", "interpolate", "rasterize"]

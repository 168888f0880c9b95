"""Triangle setup, binning, visibility raster and resolve."""

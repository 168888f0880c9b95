"""Frame constants, render targets, scene snapshot."""

"""Host utilities of the engine (counterpart of sailor_tpu/utils/)."""

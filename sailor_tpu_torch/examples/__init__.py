"""The JAX package's examples (examples/render_frame.py, examples/trace.py)
on the port: ``python -m sailor_tpu_torch.examples.render_frame`` and
``python -m sailor_tpu_torch.examples.trace``, on the card unless
``--cpu`` is given."""

"""The JAX package's ``examples/`` on the port, one module each. Run one with
``python -m xsarsea_tpu_torch.examples.<name>`` (on the card), or call its
``main(device=..., <size>)``; each prints its counterpart's headline and
returns its numbers. Importing a module runs nothing."""

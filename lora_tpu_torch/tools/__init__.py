"""Kernel studies of the port, each runnable as ``python -m
lora_tpu_torch.tools.<name>`` on a machine with a card:

- :mod:`~lora_tpu_torch.tools.profile_detect` times the detection metric's
  two kernels, ``"pp"`` (K1) against the staged ``"tile"`` (K2);
- :mod:`~lora_tpu_torch.tools.profile_packing` times the plane-major
  layout (K1) against the window-major one (K6) and the plain version.

They do no work when imported, and raise without a card.
"""

"""LoRa transmitter (numpy), for building test and smoke inputs."""

from .modulator import Modulator, modulate_frame  # noqa: F401

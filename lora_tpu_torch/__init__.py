"""lora_tpu_torch — the LoRa receiver framework in PyTorch and CUDA.

A port of ``lora_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100: plain
tensor code in torch, and every TPU kernel as a kernel written by hand
for Hopper. The package imports torch and numpy only. Entry points run on
the card unless the caller passes ``device="cpu"``.

Ported so far:

- the dense receiver (``DenseReceiver``) on both engines, the gradient
  engine (the default at decimation >= 4) and the fft engine, with the
  detection metric as a CUDA kernel (``csrc/det_metrics.cu``), per-channel
  lanes or one global candidate pool, the fft drift pass and the no-fold
  demod of SF12 at 250 ksps; implicit headers, the coherent ``low_snr``
  mode, ``debug_trace`` and the complex-input cores (``process_complex``,
  ``process_pooled``);
- the receiver facade (``LoRaReceiver``) with the golden engine (the
  numpy reference model, ``rx.golden``) and the dense engine, channelizing
  on the card (``channelizer.freq_xlating_fir``, ``channelize_list``); the
  suite generator and runner (``testsuite``, with ``tx.altmod`` and
  ``io.sigmf``) and the ``decode-file``, ``gen-suite`` and ``testsuite``
  commands;
- the wideband PFB receiver (``WidebandReceiver``) and its polyphase
  channelizer (``PolyphaseChannelizer``), with the branch FIR as a CUDA
  kernel (``csrc/pfb_fir.cu``);
- the multi-SF gateway (``MultiSFWidebandReceiver``), with every SF's
  detection from one multi-lag CUDA kernel (``csrc/lag_rows.cu``);
- the LoRaWAN plan gateway (``PlanGateway``): every in-band channel of a
  regional plan at every SF, with the fused mix + decimating FIR + output
  ramp channelizer as a CUDA kernel (``csrc/fused_chan.cu``);
- the detection metric's staged "tile" kernel (``csrc/det_tile.cu``) and
  its window-major kernel (``csrc/det_wm.cu``), with the studies that
  time them against the "pp" kernel (``lora_tpu_torch.tools``), and the
  per-stage timing study (``profiling``; ``python -m lora_tpu_torch.cli
  timings``);
- streaming (``stream``: ``StreamingReceiver``,
  ``WidebandStreamingReceiver``) through the package's own C++ sample
  ring (``native``) and page-locked staging, the UDP and file frame sinks
  (``io.udp``, ``io.sinks``), and the ``gateway`` command
  (``python -m lora_tpu_torch.cli gateway``).
"""

__version__ = "0.1.0"

from .config import LoRaConfig  # noqa: F401
from .io.frames import Frame, PhyHeader  # noqa: F401


def __getattr__(name):  # lazy: the receivers pull in torch
    if name == "LoRaReceiver":
        from .receiver import LoRaReceiver

        return LoRaReceiver
    if name == "DenseReceiver":
        from .rx.dense import DenseReceiver

        return DenseReceiver
    if name == "WidebandReceiver":
        from .wideband import WidebandReceiver

        return WidebandReceiver
    if name == "MultiSFWidebandReceiver":
        from .wideband import MultiSFWidebandReceiver

        return MultiSFWidebandReceiver
    if name == "PlanGateway":
        from .plans import PlanGateway

        return PlanGateway
    if name == "PolyphaseChannelizer":
        from .channelizer import PolyphaseChannelizer

        return PolyphaseChannelizer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""The program's faults that keep cells out of the benchmark, each beside
a witness that sides with the reference. CPU, about a minute:

    python3 gwbench/faults.py

1. Alignment: through ``PlanGateway`` (one US915 channel at 16 Msps, the
   cells' filter and decimation), a clean SF7 frame decodes wrong when its
   first sample lands within about 0.15 channel samples of ``sps/2 - 1``
   or ``sps/2 + 1`` past the receiver's window grid; a quarter sample
   away the same frame decodes right.
2. SF12 at full rate: ``DenseReceiver`` at 250 ksps decodes some 30 dB
   SF12 frames without low-data-rate optimisation wrong, by where they
   start; the same payloads with it (the path ``PlanGateway`` cannot
   select) all decode right.
3. Capacity: six SF7 frames on one channel in one block; ``PlanGateway``
   drops two (it calls ``process_pooled_planes`` with its default of 4
   candidates a channel), the same call with 8 decodes all six.
4. The gradient engine at 4 samples a chip: ``PlanGateway`` at 500 ksps
   channels picks it (``demod_method="auto"``) and decodes some clean
   SF7 frames at free starts wrong; the fft engine at the same rate, on
   the same frames, decodes them all.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gwbench import traffic as gen  # noqa: E402

F0, CENTER, FS = 902.3e6, 908.6e6, 16e6
CFG = dict(channels_hz=[F0], center_hz=CENTER, samp_rate=FS, chan_rate=250e3,
           bandwidth=125e3, cr=1, sync_word=0x34, sfs=[7])


def _gateway(pool: int, chan_rate: float = 250e3, **kw):
    from lora_tpu_torch.plans import PlanGateway

    return PlanGateway([F0], CENTER, FS, chan_rate=chan_rate, sfs=(7,), cr=1, device="cpu",
                       pool=pool, **kw)


def _grid_start(start: float, gw) -> float:
    """The first wideband start at or after ``start`` whose frame's first
    sample lands on an SF7 window edge at the channel rate (output ``n``
    is centred on input ``n D + (K - 1) / 2``)."""
    sym = gw.rxs[7].sps * gw.decim
    c = (len(gw.taps) - 1) / 2.0
    return c + math.ceil((start - c) / sym) * sym


def _decode(gw, uplinks, per_channel=None, cfg=CFG):
    """Frames right of ``uplinks`` decoded from one block, and n_dropped."""
    from lora_tpu_torch.plans import multi_sf_detection_metrics
    from lora_tpu_torch.wideband import _frames_from_pooled

    rx = gw.rxs[7]
    K, D = len(gw.taps), gw.decim
    end = max(math.ceil(u.start) + u.airtime_samples(cfg) for u in uplinks)
    L = end + (gw.max_pkt_samples + 2 * rx.sps + (-(-K // D) + 1)) * D
    x = torch.randn((2, L), generator=torch.Generator().manual_seed(3)) * math.sqrt(0.5)
    for u in uplinks:
        gen.add_uplink(x, u, cfg)
    if per_channel is None:
        res = gw.process_planes(x)[7]
    else:
        cp = gw.channel_planes(x).contiguous()
        m = multi_sf_detection_metrics(cp, {7: rx.sps})[7]
        res = rx.process_pooled_planes(cp, gw.pool, per_channel=per_channel, metrics=m)
    frames = _frames_from_pooled(res, np.arange(1), rx.cfg, np.zeros(1))
    right = sum(any(f.payload[:-2] == u.phy for f in frames) for u in uplinks)
    return right, int(res.n_dropped)


def alignment() -> dict:
    gw = _gateway(8)
    sps, D = gw.rxs[7].sps, gw.decim
    payload = b"\x40" + bytes(range(1, 21))
    out = {}
    for off in (126.75, 127.0, 127.25, 128.0, 128.75, 129.0, 129.25):
        start = _grid_start(4 * sps * D, gw) + off * D
        u = gen.Uplink(0, 7, start, payload, 30.0, 0.0, 0.0, 0.3)
        out[off] = _decode(gw, [u])[0] == 1
    return out


def sf12_full_rate() -> dict:
    from lora_tpu_torch.config import LoRaConfig
    from lora_tpu_torch.rx.dense import DenseReceiver
    from lora_tpu_torch.tx.modulator import modulate_frame

    payload = bytes(range(20))
    out = {}
    for ldro in (False, True):
        cfg = LoRaConfig(sf=12, cr=1, samp_rate=250e3, sync_word=0x34, reduced_rate=ldro)
        rx = DenseReceiver(cfg, device="cpu")
        ok = []
        for d in (24, 117, 142, 339, 1, 11):
            x = modulate_frame(cfg, payload, pad_before=3 * rx.sps + d,
                               pad_after=rx.pkt_samples, snr_db=30.0)
            ok.append(any(f.payload[:-2] == payload for f in rx.run(x)))
        out["ldro" if ldro else "full rate"] = ok
    return out


def capacity() -> dict:
    gw = _gateway(16)
    sps, D = gw.rxs[7].sps, gw.decim
    rng = np.random.default_rng(1)
    ups, pos = [], 4 * sps * D
    for _ in range(6):
        s = _grid_start(pos, gw)
        u = gen.Uplink(0, 7, s, b"\x40" + rng.integers(0, 256, 20, dtype=np.uint8).tobytes(),
                       25.0, 0.0, 0.0, 0.1)
        ups.append(u)
        pos = s + u.airtime_samples(CFG) + 3 * sps * D
    return {"PlanGateway (right, n_dropped)": _decode(gw, ups),
            "per_channel=8 (right, n_dropped)": _decode(gw, ups, per_channel=8)}


def gradient_engine() -> dict:
    cfg = dict(CFG, chan_rate=500e3)
    rng = np.random.default_rng(4)
    ups = []
    for _ in range(40):
        payload = b"\x40" + rng.integers(0, 256, 20, dtype=np.uint8).tobytes()
        ups.append(gen.Uplink(0, 7, 3000.0 + rng.uniform(0, 8192), payload, 25.0, 0.0,
                              0.0, 0.3))
    out = {}
    for method in ("gradient", "fft"):
        gw = _gateway(8, 500e3, demod_method=method)
        out[method] = sum(_decode(gw, [u], cfg=cfg)[0] for u in ups)
    return {k: f"{v} of {len(ups)}" for k, v in out.items()}


if __name__ == "__main__":
    torch.set_num_threads(4)
    print("1. SF7 frame decoded right, by where it starts past the window grid:", alignment())
    print("2. SF12 frames decoded right, by start offset:", sf12_full_rate())
    print("3. six SF7 frames on one channel:", capacity())
    print("4. SF7 frames at free starts decoded right at 500 ksps, by engine:",
          gradient_engine())

"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package (the parity engine, the flowgraph, the debugger and the sharding
package included), its entry points (the mesh's default devices too)
default to the card and refuse to fall back to the CPU, and the
detection-kernel wrapper dispatches by device."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lora_tpu_torch
from lora_tpu_torch import DenseReceiver, LoRaConfig
from lora_tpu_torch.ops.cuda_kernels import (detection_metrics_kernel,
                                             detection_metrics_planes)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "lora_tpu")


def test_import_leaves_jax_and_lora_tpu_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import lora_tpu_torch\n"
        "for m in pkgutil.walk_packages(lora_tpu_torch.__path__, 'lora_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "lora_tpu_torch.DenseReceiver, lora_tpu_torch.WidebandReceiver\n"
        "lora_tpu_torch.PolyphaseChannelizer, lora_tpu_torch.MultiSFWidebandReceiver\n"
        "lora_tpu_torch.PlanGateway, lora_tpu_torch.LoRaReceiver\n"
        "from lora_tpu_torch.rx.golden import GoldenReceiver\n"
        "from lora_tpu_torch.testsuite import generate_suite, run_suite\n"
        "from lora_tpu_torch.tx.altmod import modulate_frame_alt\n"
        "from lora_tpu_torch.io.sigmf import read_trace, write_trace\n"
        "from lora_tpu_torch.stream import StreamingReceiver, WidebandStreamingReceiver\n"
        "from lora_tpu_torch.io.udp import MessageSocketSink\n"
        "from lora_tpu_torch.io.sinks import MessageFileSink\n"
        "from lora_tpu_torch.native import SampleRing\n"
        "from lora_tpu_torch.rx.receiver import ParityReceiver\n"
        "from lora_tpu_torch.flowgraph import Flowgraph, StreamingLoRaReceiver, run_flowgraph\n"
        "from lora_tpu_torch.debugger import SampleDebugger, live_analyze\n"
        "lora_tpu_torch.ParityReceiver, lora_tpu_torch.Flowgraph, lora_tpu_torch.run_flowgraph\n"
        "from lora_tpu_torch.parallel import (make_mesh, channel_sharded_process,\n"
        "    time_sharded_process, wideband_time_sharded_process,\n"
        "    wideband_subband_sharded_process, subband_channel_freq)\n"
        "lora_tpu_torch.make_mesh, lora_tpu_torch.wideband_subband_sharded_process\n"
        "SampleRing(64).close()\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'libhost_io-' in maps and 'libloratpu_host' not in maps, 'host library'\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _sources():
    return sorted((ROOT / "lora_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_host_library_is_the_ports_own():
    """The streamers' ring and the sinks load the port's own build of its
    own source, never ``lora_tpu/native``'s library."""
    from lora_tpu_torch import native

    assert native.SRC == ROOT / "lora_tpu_torch" / "native" / "host_io.cpp"
    path = Path(native.load()._name)
    assert path.parent == ROOT / "lora_tpu_torch" / "build"
    assert path.name.startswith("libhost_io-") and path == native.library_path(path.parent)


def test_receiver_defaults_to_the_card():
    cfg = LoRaConfig(sf=7, cr=4, samp_rate=250e3)
    if torch.cuda.is_available():
        assert DenseReceiver(cfg, demod_method="fft").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DenseReceiver(cfg, demod_method="fft")
    assert DenseReceiver(cfg, demod_method="fft", device="cpu").device.type == "cpu"


def test_parity_and_flowgraph_default_to_the_card(tmp_path):
    """The parity engine, its facade, the flowgraph's receiver blocks and a
    graph holding one take the card by default and raise without it."""
    from lora_tpu_torch import Flowgraph, LoRaReceiver, ParityReceiver
    from lora_tpu_torch.flowgraph import StreamingGateway, StreamingLoRaReceiver

    cfg = LoRaConfig(sf=7, cr=4, samp_rate=1e6)
    path = tmp_path / "x.cf32"
    np.zeros(4096, np.complex64).tofile(path)
    spec = {"blocks": [{"name": "src", "id": "file_source", "parameters": {"file": str(path)}},
                       {"name": "rx", "id": "lora_receiver",
                        "parameters": {"samp_rate": 1e6, "center_freq": 868e6,
                                       "channel_list": [868.1e6]}}],
            "connections": [["src", "0", "rx", "0"]]}
    makers = [
        lambda **kw: ParityReceiver(cfg, **kw),
        lambda **kw: LoRaReceiver(1e6, 868e6, [868e6], 125e3, 7, engine="parity", **kw),
        lambda **kw: StreamingLoRaReceiver(1e6, 868e6, [868.1e6], engine="parity", **kw),
        lambda **kw: StreamingGateway(samp_rate=1e6, channels=4, sfs=(7,), **kw),
        lambda **kw: Flowgraph(spec, **kw),
    ]
    for make in makers:
        if torch.cuda.is_available():
            continue
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert ParityReceiver(cfg, device="cpu").device.type == "cpu"
    assert StreamingLoRaReceiver(1e6, 868e6, [868.1e6], engine="parity",
                                 device="cpu").device.type == "cpu"


def test_mesh_defaults_to_the_cards():
    """``make_mesh()`` builds its mesh of the cards, and raises without
    one rather than building a CPU mesh; a CPU mesh is asked for by name."""
    from lora_tpu_torch.parallel import make_mesh

    if torch.cuda.is_available():
        assert {d.type for d in make_mesh().devices} == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    assert make_mesh(devices=["cpu"] * 2).devices == (torch.device("cpu"),) * 2


def test_wrapper_cpu_tensor_takes_plain_version():
    rng = np.random.default_rng(3)
    xf = torch.from_numpy(rng.normal(size=(2, 2, 9 * 256)).astype(np.float32))
    before = detection_metrics_kernel.launches
    got = detection_metrics_kernel(xf, 256)
    ref = detection_metrics_planes(xf, 256)
    assert detection_metrics_kernel.launches == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex64, torch.float16])
def test_wrapper_refuses_other_dtypes(dtype):
    xf = torch.zeros((1, 2, 1024), dtype=dtype)
    with pytest.raises(TypeError):
        detection_metrics_kernel(xf, 256)


@pytest.mark.parametrize("shape,sps", [((1, 3, 1024), 256), ((2, 1024), 1024),
                                       ((1024,), 256)])
def test_wrapper_refuses_bad_geometry(shape, sps):
    with pytest.raises(ValueError):
        detection_metrics_kernel(torch.zeros(shape), sps)


def test_package_exports():
    from lora_tpu_torch.channelizer import PolyphaseChannelizer
    from lora_tpu_torch.plans import PlanGateway
    from lora_tpu_torch.receiver import LoRaReceiver
    from lora_tpu_torch.wideband import MultiSFWidebandReceiver, WidebandReceiver

    assert lora_tpu_torch.LoRaConfig is LoRaConfig
    assert lora_tpu_torch.WidebandReceiver is WidebandReceiver
    assert lora_tpu_torch.MultiSFWidebandReceiver is MultiSFWidebandReceiver
    assert lora_tpu_torch.PolyphaseChannelizer is PolyphaseChannelizer
    assert lora_tpu_torch.PlanGateway is PlanGateway
    assert lora_tpu_torch.LoRaReceiver is LoRaReceiver
    from lora_tpu_torch.flowgraph import Flowgraph, run_flowgraph
    from lora_tpu_torch.rx.receiver import ParityReceiver

    assert lora_tpu_torch.ParityReceiver is ParityReceiver
    assert lora_tpu_torch.Flowgraph is Flowgraph
    assert lora_tpu_torch.run_flowgraph is run_flowgraph
    from lora_tpu_torch import parallel

    for name in ("make_mesh", "channel_sharded_process", "time_sharded_process",
                 "wideband_time_sharded_process", "wideband_subband_sharded_process",
                 "subband_channel_freq"):
        assert getattr(lora_tpu_torch, name) is getattr(parallel, name), name
        assert f"``{name}``" in lora_tpu_torch.__doc__, name
    with pytest.raises(AttributeError):
        lora_tpu_torch.NoSuchReceiver

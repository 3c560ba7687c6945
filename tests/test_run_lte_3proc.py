"""Three-process E2E over real sockets: the
`test/run_lte.sh:288-312` process topology — UE ↔ eNB over PHY I/Q
frames, eNB ↔ EPC over S1AP (length-framed TCP, the SCTP stand-in for
`mme.cc:25`) and GTP-U on UDP (`gtpu.cc`) — with IP payloads delivered
in both directions across all three process boundaries."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

APP = os.path.join(os.path.dirname(__file__), "..", "apps",
                   "run_lte_3proc.py")


def _free_ports(n):
    import socket

    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _launch(duration: float, tun: bool = False, netns: str = ""):
    p1, p2, p3 = _free_ports(3)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(
        os.path.dirname(__file__), ".."))
    common = [sys.executable, "-u", APP, "--duration", str(duration),
              "--prb", "15"]
    tun_args = (["--tun", "--netns", netns] if tun else [])
    epc = subprocess.Popen(
        common + ["--role", "epc", "--s1ap-port", str(p1),
                  "--gtpu-port", str(p2)] + tun_args,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
    time.sleep(1.5)
    enb = subprocess.Popen(
        common + ["--role", "enb", "--s1ap", f"127.0.0.1:{p1}",
                  "--gtpu", f"127.0.0.1:{p2}", "--phy-port", str(p3)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
    time.sleep(1.5)
    ue = subprocess.Popen(
        common + ["--role", "ue", "--phy", f"127.0.0.1:{p3}"] + tun_args,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
    outs = {}
    for name, proc in (("ue", ue), ("enb", enb), ("epc", epc)):
        out, _ = proc.communicate(timeout=duration + 120)
        for line in out.splitlines():
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            if d.get("role") == name:
                outs[name] = d
        assert name in outs, f"{name} produced no result line:\n{out}"
    return outs


def test_three_process_attach_and_ip():
    outs = _launch(duration=45.0)
    assert outs["ue"]["registered"], outs
    assert outs["epc"]["attached"] == ["001010123456789"], outs
    # DL: EPC SGi → GTP-U/UDP → eNB proc → PHY frames → UE proc
    assert outs["ue"]["ip_rx"] >= 6, outs
    # UL: UE proc → PHY → eNB → GTP-U/UDP → EPC SGi
    assert outs["epc"]["sgi_rx"] >= 3, outs
    assert outs["enb"]["ttis"] > 500, outs


NS = "srstpu_3p"


def _netns_ok() -> bool:
    if os.geteuid() != 0 or shutil.which("ip") is None:
        return False
    r = subprocess.run(["ip", "netns", "add", NS], capture_output=True)
    if r.returncode != 0:
        return False
    return True


def test_three_process_kernel_ping():
    """run_lte.sh in full: UE TUN in a netns, real ICMP through all
    three processes and both socket transports."""
    from srsran_tpu.io.tun import TunDevice

    if not TunDevice.available():
        pytest.skip("no TUN in this environment")
    if not _netns_ok():
        pytest.skip("cannot create network namespaces")
    # stale devices from an earlier crashed run hold the names busy
    subprocess.run(["ip", "link", "del", "tun_sgi3p"],
                   capture_output=True)
    try:
        outs = _launch(duration=55.0, tun=True, netns=NS)
        assert outs["ue"]["registered"], outs
        assert outs["ue"]["ping_rc"] == 0, outs["ue"]
    finally:
        subprocess.run(["ip", "netns", "del", NS], capture_output=True)

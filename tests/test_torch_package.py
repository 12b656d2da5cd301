"""Package-level checks of the PyTorch + CUDA port.

* Importing ``tpu_dpow_torch`` and every submodule loads neither ``jax`` nor
  any module of ``tpu_dpow`` (checked in a fresh interpreter), the device
  fan, the mesh gang, the multi-host layout, the chaos seam, the fault
  domains, the logging helper, the worker client, the transport, the
  tracer and the hub with its store, sched, fleet, replica and precache
  layers, the MQTT and websocket faces, the load generator, the native and
  subprocess engines, the failover chain, the work server and the six
  operator scripts included; ``python -m tpu_dpow_torch.client --help``
  exits 0.
* The kernel's arithmetic header (``ops/csrc/blake2b_search.cuh``), built for
  the host with ``g++``, gives hashlib's work values, and each of its
  FMA-pipe forms equals plain integer arithmetic.
* ``chip_smoke.py`` fails, and prints no result, where no card is visible;
  its SASS count takes the named kernel's scan loop.
* On a card (marker ``cuda``, skipped here; run with ``python -m pytest
  --noconftest -m cuda tests/test_torch_package.py``): each kernel equals its
  plain version bit for bit — the search kernel at every launch shape the
  engine emits, the persistent run kernel with and without a scripted
  control channel, its LaunchControl bookkeeping and re-granted windows
  included, at the persistent engine's shapes and with strided windows —
  each launch moves its counter by one, and the fan and mesh functions over
  every visible card equal their plain versions. The search kernel counts
  the nonces each row ran, and a row whose out word is lowered mid-launch
  from another stream stops short of its span. Each kernel's scan loop
  keeps its pipe budget in the SASS.
"""

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpu_dpow_torch.ops import control, cuda_kernel, runloop, search

# The suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding out the others on the same cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUH = os.path.join(REPO, "tpu_dpow_torch", "ops", "csrc", "blake2b_search.cuh")
MAX_U64 = (1 << 64) - 1
EASY = 0xFFF0000000000000


def ref_value(nonce: int, h: bytes) -> int:
    return int.from_bytes(
        hashlib.blake2b(struct.pack("<Q", nonce & MAX_U64) + h, digest_size=8).digest(),
        "little",
    )


def test_import_loads_neither_jax_nor_the_jax_package():
    probe = (
        "import importlib, pkgutil, sys\n"
        "import tpu_dpow_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(tpu_dpow_torch.__path__, 'tpu_dpow_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.') or m == 'tpu_dpow'\n"
        "             or m.startswith('tpu_dpow.'))\n"
        "need = {'tpu_dpow_torch.parallel', 'tpu_dpow_torch.parallel.fan_search',\n"
        "        'tpu_dpow_torch.chaos', 'tpu_dpow_torch.chaos.device',\n"
        "        'tpu_dpow_torch.resilience.devfault', 'tpu_dpow_torch.resilience.breaker',\n"
        "        'tpu_dpow_torch.utils.logging', 'tpu_dpow_torch.parallel.mesh_search',\n"
        "        'tpu_dpow_torch.parallel.multihost', 'tpu_dpow_torch.client',\n"
        "        'tpu_dpow_torch.client.__main__', 'tpu_dpow_torch.client.app',\n"
        "        'tpu_dpow_torch.transport', 'tpu_dpow_torch.transport.tcp',\n"
        "        'tpu_dpow_torch.transport.wire', 'tpu_dpow_torch.obs.prom',\n"
        "        'tpu_dpow_torch.obs.trace', 'tpu_dpow_torch.server',\n"
        "        'tpu_dpow_torch.server.__main__', 'tpu_dpow_torch.server.app',\n"
        "        'tpu_dpow_torch.server.api', 'tpu_dpow_torch.server.nano_ws',\n"
        "        'tpu_dpow_torch.store', 'tpu_dpow_torch.store.sqlite_store',\n"
        "        'tpu_dpow_torch.store.redis_store', 'tpu_dpow_torch.store.degraded',\n"
        "        'tpu_dpow_torch.sched', 'tpu_dpow_torch.sched.window',\n"
        "        'tpu_dpow_torch.fleet', 'tpu_dpow_torch.fleet.coordinator',\n"
        "        'tpu_dpow_torch.replica', 'tpu_dpow_torch.replica.ring',\n"
        "        'tpu_dpow_torch.precache', 'tpu_dpow_torch.precache.pipeline',\n"
        "        'tpu_dpow_torch.chaos.store', 'tpu_dpow_torch.chaos.transport',\n"
        "        'tpu_dpow_torch.chaos.backend', 'tpu_dpow_torch.resilience.supervisor',\n"
        "        'tpu_dpow_torch.utils.throttle', 'tpu_dpow_torch.transport.mqtt',\n"
        "        'tpu_dpow_torch.transport.ws', 'tpu_dpow_torch.transport.__main__',\n"
        "        'tpu_dpow_torch.loadgen', 'tpu_dpow_torch.loadgen.arrival',\n"
        "        'tpu_dpow_torch.loadgen.population', 'tpu_dpow_torch.loadgen.recorder',\n"
        "        'tpu_dpow_torch.loadgen.driver', 'tpu_dpow_torch.loadgen.responder',\n"
        "        'tpu_dpow_torch.loadgen.config', 'tpu_dpow_torch.backend.native_backend',\n"
        "        'tpu_dpow_torch.backend.subprocess_backend', 'tpu_dpow_torch.resilience.failover',\n"
        "        'tpu_dpow_torch.workserver', 'tpu_dpow_torch.workserver.__main__',\n"
        "        'tpu_dpow_torch.scripts', 'tpu_dpow_torch.scripts.services',\n"
        "        'tpu_dpow_torch.scripts.client_snapshot', 'tpu_dpow_torch.scripts.payouts',\n"
        "        'tpu_dpow_torch.scripts.check_latency', 'tpu_dpow_torch.scripts.chaos_demo',\n"
        "        'tpu_dpow_torch.autoscale', 'tpu_dpow_torch.autoscale.config',\n"
        "        'tpu_dpow_torch.autoscale.signals', 'tpu_dpow_torch.autoscale.controller',\n"
        "        'tpu_dpow_torch.autoscale.journal', 'tpu_dpow_torch.autoscale.actuator',\n"
        "        'tpu_dpow_torch.autoscale.__main__', 'tpu_dpow_torch.loadgen.sim',\n"
        "        'tpu_dpow_torch.analysis', 'tpu_dpow_torch.analysis.sanitizer',\n"
        "        'tpu_dpow_torch.analysis.__main__'}\n"
        "print(len(names), sorted(need - set(names)), bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    count, missing, bad = out.stdout.strip().split(" ", 2)
    assert int(count) >= 40  # every module of the port was imported
    assert missing == "[]" and bad == "[]"


def test_autoscaler_and_sim_load_no_torch():
    """A replica the autoscaler spawns, and the autoscaler itself, open no
    CUDA context: the autoscale package, the sim and the hub they drive
    import without torch (and without jax or tpu_dpow)."""
    probe = (
        "import sys\n"
        "import tpu_dpow_torch.autoscale, tpu_dpow_torch.autoscale.__main__\n"
        "import tpu_dpow_torch.autoscale.actuator, tpu_dpow_torch.loadgen.sim\n"
        "import tpu_dpow_torch.server.app\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'tpu_dpow')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_client_entry_point_help_exits_zero():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "tpu_dpow_torch.client", "--help"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "--mesh_devices" in out.stdout and "--device" in out.stdout


def test_cuh_host_build_matches_hashlib(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the header's host build cannot be compiled")
    src = tmp_path / "pow.cc"
    src.write_text(
        f'#include "{CUH}"\n'
        'extern "C" uint64_t pow_value(uint64_t n, const uint64_t* h) {\n'
        "  return b2pow::pow_value(n, h[0], h[1], h[2], h[3]);\n"
        "}\n"
    )
    lib_path = tmp_path / "libpow.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(lib_path), str(src)],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.pow_value.argtypes = [ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)]
    lib.pow_value.restype = ctypes.c_uint64
    rng = np.random.default_rng(2)
    edges = [0, 1, 0xFFFFFFFF, 1 << 32, (1 << 63) - 1, 1 << 63, MAX_U64 - 1, MAX_U64]
    for _ in range(16):
        h = rng.bytes(32)
        words = (ctypes.c_uint64 * 4)(*struct.unpack("<4Q", h))
        nonces = edges + [int(x) for x in rng.integers(0, 1 << 64, size=8, dtype=np.uint64)]
        for n in nonces:
            assert lib.pow_value(n, words) == ref_value(n, h), (h.hex(), n)


MASK32 = (1 << 32) - 1


def _dp4a(a: int, b: int, c: int) -> int:
    return (c + sum(((a >> i) & 0xFF) * ((b >> i) & 0xFF) for i in (0, 8, 16, 24))) & MASK32


def _dp2a_lo(a: int, b: int, c: int) -> int:
    return (c + (a & 0xFFFF) * (b & 0xFF) + (a >> 16) * ((b >> 8) & 0xFF)) & MASK32


# Each FMA-pipe form of the header (the card's PTX instruction's definition,
# or a rotation built of them at the multipliers the card reads) and the
# plain arithmetic it must equal.
FMA_FORMS = {
    "mad_lo": (3, lambda a, b, c: (a * b + c) & MASK32),
    "dp4a": (3, _dp4a),
    "dp2a_lo": (3, _dp2a_lo),
    "rotr24_fma": (1, lambda x: ((x >> 24) | (x << 40)) & MAX_U64),
    "rotr16_fma": (1, lambda x: ((x >> 16) | (x << 48)) & MAX_U64),
}


@pytest.fixture(scope="module")
def cuh_fma_forms(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the header's host build cannot be compiled")
    tmp = tmp_path_factory.mktemp("cuh_fma")
    src = tmp / "fma.cc"
    src.write_text(
        f'#include "{CUH}"\n'
        'using namespace b2pow;\n'
        'extern "C" {\n'
        "uint32_t t_mad_lo(uint32_t a, uint32_t b, uint32_t c) { return mad_lo(a, b, c); }\n"
        "uint32_t t_dp4a(uint32_t a, uint32_t b, uint32_t c) { return dp4a(a, b, c); }\n"
        "uint32_t t_dp2a_lo(uint32_t a, uint32_t b, uint32_t c) { return dp2a_lo(a, b, c); }\n"
        "uint64_t t_rotr24_fma(uint64_t x) { return rotr24_fma(x, ROT24_UP, ROT24_DOWN); }\n"
        "uint64_t t_rotr16_fma(uint64_t x) { return rotr16_fma(x, ROT16_UP, ROT16_DOWN); }\n"
        "}\n"
    )
    lib_path = tmp / "libfma.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(lib_path), str(src)],
        check=True, capture_output=True, timeout=120,
    )
    return ctypes.CDLL(str(lib_path))


@pytest.mark.parametrize("name", sorted(FMA_FORMS))
def test_cuh_fma_form_equals_plain_arithmetic(cuh_fma_forms, name):
    """The header's host build of each FMA-pipe form against plain integer
    arithmetic, on seeded random words and on the edges: zero, all-ones,
    a single bit at each half's ends, and sums that wrap 2^32. The card
    runs the same rotations, so the cuda-marked kernel tests hold the PTX
    instructions to these definitions."""
    arity, plain = FMA_FORMS[name]
    fn = getattr(cuh_fma_forms, "t_" + name)
    word = ctypes.c_uint32 if arity == 3 else ctypes.c_uint64
    fn.argtypes, fn.restype = [word] * arity, word
    rng = np.random.default_rng(21)
    if arity == 3:
        edges = [0, 1, 0xFF, 0xFFFF, 1 << 31, 0x01000000, 0x0100, 0xFF00FF00, MASK32]
        cases = [(a, b, c) for a in edges for b in edges for c in (0, 1, MASK32 - 3, MASK32)]
        cases += [tuple(int(x) for x in rng.integers(0, 1 << 32, size=3, dtype=np.uint64))
                  for _ in range(4096)]
    else:
        edges = [0, 1, MAX_U64, MAX_U64 - 1, 1 << 63, 1 << 32, (1 << 32) - 1, 0xFF << 24,
                 0xFFFF << 16, 0x00FF00FF00FF00FF, 0x0123456789ABCDEF]
        cases = [(x,) for x in edges]
        cases += [(int(x),) for x in rng.integers(0, 1 << 64, size=4096, dtype=np.uint64)]
    for args in cases:
        assert fn(*args) == plain(*args), (name, [hex(a) for a in args])


def test_chip_smoke_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _chip_smoke():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def _sass_listing(functions) -> str:
    """A ``cuobjdump -sass`` listing of ``functions``: (name, body) pairs,
    each body a list of instructions ("OP operands") and labels (".L_x_N:"),
    at 16-byte addresses from 0."""
    lines = []
    for name, body in functions:
        lines += [f"\t\tFunction : {name}", '\t.headerflags\t@"EF_CUDA_SM90"']
        addr = 0
        for item in body:
            if item.endswith(":"):
                lines.append(item)
                continue
            lines.append(f"        /*{addr:04x}*/                   {item} ;"
                         "                                /* 0x0000000000000000 */")
            lines.append(" " * 89 + "/* 0x000fe20000000000 */")
            addr += 16
    return "\n".join(lines) + "\n"


def _body(alu: int, fma: int, half_rate: int = 0, spills: int = 0) -> list:
    return (["LOP3.LUT R2, R3, R4, RZ, 0x3c, !PT"] * (alu // 2)
            + ["SHF.L.W.U32.HI R5, R6, 0x8, R7"] * (alu - alu // 2)
            + ["IMAD.X R8, R9, 0x1, R10, P0"] * (fma - half_rate)
            + ["IMAD.HI.U32 R11, R12, UR4, RZ"] * (half_rate // 2)
            + ["IMAD.WIDE.U32 R12, R13, UR4, RZ"] * (half_rate - half_rate // 2)
            + ["STL [R1], R2", "LDL R2, [R1]"][:spills]
            + ["IMAD.WIDE.U32 R20, R0, 0x4, R20"]  # an address: not half-rate work
            + ["UIMAD.WIDE.U32 UR6, UR6, UR4, URZ", "REDUX.MIN UR5, R2"])


@pytest.mark.parametrize("target", ["address", "label"])
def test_sass_count_takes_the_scan_loop_of_the_named_kernel(target):
    """``chip_smoke.count_sass``, which the on-card pipe check reads: the
    named kernel's innermost loop that holds 1,000+ integer instructions
    (not the outer loop around it, a short loop after it, or another
    kernel), split by pipe, with its half-rate IMAD forms and spills."""
    chip_smoke = _chip_smoke()
    scan = _body(1200, 300, half_rate=5, spills=2)  # and an address's IMAD.WIDE
    prologue = ["LDC R1, c[0x0][0x28]", "IADD3 R0, R0, 0x1, RZ", "IMAD.MOV.U32 R3, RZ, RZ, 0x7"]
    # addresses: 3 prologue, the scan loop from 0x30, its branch, then a
    # short loop and the outer loop's branch back to the prologue's end
    start, end = 3 * 16, (3 + len(scan)) * 16
    back = (f"BRA 0x{start:x}" if target == "address" else "BRA `(.L_x_7)")
    kernel = (prologue[:1] + ([".L_x_3:"] if target == "label" else []) + prologue[1:]
              + ([".L_x_7:"] if target == "label" else []) + scan
              + [f"@!P0 {back}", "LOP3.LUT R2, R2, R3, RZ, 0xfc, !PT",
                 f"@P1 BRA 0x{end + 16:x}",
                 "@P2 BRA `(.L_x_3)" if target == "label" else "@P2 BRA 0x10", "EXIT"])
    decoy = _body(2000, 10, half_rate=10) + ["@P0 BRA 0x0"]
    listing = _sass_listing([("_Z12check_kernelPKmPyj", decoy),
                             ("_Z16b2_search_kernelPKjPjS1_j", kernel)])
    got = chip_smoke.count_sass(listing, "b2_search_kernel")
    fma = sum(n for op, n in got["loop"].items() if op in chip_smoke.FMA_OPS)
    assert (sum(got["loop"].values()) - fma, fma) == (1200, 301)
    assert got["loop_range"] == [start, end]
    assert got["half_rate_in_loop"] == 5
    assert got["local_memory_ops_in_loop"] == 2
    assert sum(got["function"].values()) == 1200 + 301 + 2 + 1  # IADD3, IMAD.MOV, LOP3
    with pytest.raises(RuntimeError):
        chip_smoke.count_sass(listing, "b2_run_kernel")


def test_queued_launch_sleeps_until_its_start_event():
    """A persistent launch queued behind another sleeps, its naps doubling
    from 20 µs, until the event recorded before its kernel completes."""

    class Event:
        queries = 0

        def query(self):
            self.queries += 1
            return self.queries == 4

    event = Event()
    waited_ns = cuda_kernel._sleep_until(event)
    assert event.queries == 4
    assert waited_ns >= (20 + 40 + 80) * 1000


class _FakeFn:
    """Stands in for a ctypes function: takes argtypes and restype and
    returns ``ret``."""

    def __init__(self, ret=0):
        self.ret = ret

    def __call__(self, *args):
        return self.ret


class _OutWords(_FakeFn):
    """``b2_run_out_words``: a launch's lo and hi words, then its statistics."""

    def __call__(self, rows):
        return 2 * rows + cuda_kernel._OUT_STATS


class _FakeLib:
    """Stands in for a kernel library loaded from ``path`` (its name)."""

    def __init__(self, path):
        self.b2_abi_version = _FakeFn(cuda_kernel._ABI_VERSIONS[path])
        self.b2_run_out_words = _OutWords()

    def __getattr__(self, attr):
        fn = _FakeFn()
        setattr(self, attr, fn)
        return fn


@pytest.fixture
def four_fake_cards(monkeypatch):
    """Four visible cards as far as the port asks, kernel libraries that
    load without nvcc, and mailboxes that record the card they are made
    on (the list returned)."""
    made = []

    class Mailbox:
        def __init__(self, lib, rows, device):
            self.rows, self.device = rows, device
            made.append(device)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(cuda_kernel, "build_libraries", lambda names: {n: n for n in names})
    monkeypatch.setattr(cuda_kernel.ctypes, "CDLL", _FakeLib)
    monkeypatch.setattr(cuda_kernel, "_libs", {})
    monkeypatch.setattr(cuda_kernel, "_lib_paths", {})
    monkeypatch.setattr(cuda_kernel, "_mailboxes", {})
    monkeypatch.setattr(cuda_kernel, "_Mailbox", Mailbox)
    return made


@pytest.mark.parametrize("kw,cards", [
    (dict(device="cuda:2", run_mode="persistent"), [2]),
    (dict(devices=2, run_mode="persistent"), [0, 1]),
    (dict(device="cuda:3"), []),  # chunked: no controlled launch, no mailbox
])
def test_mailboxes_are_pooled_only_on_the_engines_cards(four_fake_cards, kw, cards):
    """Loading the kernels makes no mailbox; an engine's setup pools them on
    its own cards only (a CUDA context on no other card), and a second
    setup tops the pools up without adding more. A launch on a card with
    no pool allocates its mailbox there."""
    from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend

    cuda_kernel.load_libraries()
    assert four_fake_cards == []
    engine = TorchWorkBackend(**kw)
    engine._load_kernels()
    engine._load_kernels()
    assert sorted(four_fake_cards) == [c for c in cards
                                       for _ in range(cuda_kernel._MAILBOXES_PER_CARD)]
    box = cuda_kernel._take_mailbox(cuda_kernel.load_run_library(), 16, 3)
    assert box.device == 3 and four_fake_cards[-1] == 3


# -- on the card --------------------------------------------------------------
#
# Each kernel and each multi-card function against its plain PyTorch version
# on the card, bit for bit. The engine's window is 2^25 nonces at the GPU
# geometry; CHECK_GEO's is 2^22, which keeps the plain version cheap.

DEVICE = "cuda"
CHECK_GEO = dict(sublanes=32, iters=1024, nblocks=1, group=8)
SEEDED_EVENTS = [(0, "raise", 4, 0xFFFFF00000000000), (1, "rebase", 3, MAX_U64 - 900),
                 (2, "cancel", 6, None)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def expect(k: int) -> int:
    """The difficulty whose expected first hit is ~2^k offsets in."""
    return (1 << 64) - (1 << (64 - k))


def rand_base(rng) -> int:
    return int(rng.integers(0, 1 << 63)) * 2 + int(rng.integers(0, 2))


def pack(rows) -> np.ndarray:
    return np.stack([search.pack_params(h, d, b) for h, d, b in rows])


def on_card(host: np.ndarray, device=DEVICE) -> torch.Tensor:
    return search.params_from_numpy(host, device)


def seeded_rows() -> np.ndarray:
    """Pads, a 2^32 and a 2^64 carry, easy rows and a dry row."""
    rng = np.random.default_rng(41)
    rows = [
        (rng.bytes(32), 0, int(rng.integers(0, 1 << 62))),
        (bytes(32), 0, 0),
        (rng.bytes(32), EASY, (5 << 32) - 100),
        (rng.bytes(32), EASY, MAX_U64 - 100),
        (rng.bytes(32), 0xFFFE000000000000, int(rng.integers(0, 1 << 62))),
        (rng.bytes(32), 0xFFFFC00000000000, int(rng.integers(0, 1 << 62))),
        (rng.bytes(32), MAX_U64, int(rng.integers(0, 1 << 62))),
    ]
    return pack(rows)


def planted_rows(rng) -> list:
    """max_batch (16) (hash, difficulty, base) rows: 2 pads, a 2^32 and a
    2^64 carry, 11 rows whose expected first hit is 2^16 to 2^28 offsets in,
    and one dry row. The first rows are the cheap ones, so a batch of the
    first b rows stays cheap for the plain version."""
    rows = [
        (rng.bytes(32), 0, rand_base(rng)),  # pad
        (bytes(32), 0, 0),  # pad, as the engine packs it
        (rng.bytes(32), expect(14), (5 << 32) - 300),  # crosses 2^32
        (rng.bytes(32), expect(14), MAX_U64 - 300),  # crosses 2^64
    ]
    rows += [(rng.bytes(32), expect(k), rand_base(rng))
             for k in (16, 18, 20, 21, 22, 23, 24, 25, 26, 27, 28)]
    rows.append((rng.bytes(32), MAX_U64, rand_base(rng)))  # dry: scans the whole span
    return rows


def run_rows(rng) -> list:
    """16 (hash, difficulty, base) rows for the run loop over 2^22 windows:
    2 pads, a 2^64 carry, 12 rows whose expected first hit is 2^16 to 2^27
    offsets in (windows 0 to ~32), and one dry row."""
    rows = [
        (rng.bytes(32), 0, rand_base(rng)),  # pad
        (bytes(32), 0, 0),  # pad, as the engine packs it
        (rng.bytes(32), expect(14), MAX_U64 - 300),  # crosses 2^64
    ]
    rows += [(rng.bytes(32), expect(k), rand_base(rng))
             for k in (16, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 27)]
    rows.append((rng.bytes(32), MAX_U64, rand_base(rng)))  # dry
    return rows


def fan_rows() -> tuple:
    """The 16 run_rows, and 10 of them for the fan's run loops: pads, the
    2^64 carry, first hits expected 2^16-2^21 offsets in, the dry row, and a
    row that never solves (it keeps every member polling)."""
    rng = np.random.default_rng(2032)
    host16 = pack(run_rows(rng))
    never = search.pack_params(rng.bytes(32), MAX_U64 - 1, 77)[None]
    return host16, np.concatenate([host16[[0, 1, 2, 3, 4, 5, 6, 7, 15]], never])


def row_base(row) -> int:
    return int(row[search.BASE_HI]) << 32 | int(row[search.BASE_LO])


def with_fields(row, *, difficulty=None, base=None):
    row = row.copy()
    for value, lo, hi in ((difficulty, search.DIFF_LO, search.DIFF_HI),
                          (base, search.BASE_LO, search.BASE_HI)):
        if value is not None:
            row[lo], row[hi] = value & 0xFFFFFFFF, value >> 32
    return row


def nonces(lo, hi) -> list:
    """(lo, hi) words (int32 tensors or uint32 arrays) → 64-bit nonces."""
    if isinstance(lo, torch.Tensor):
        lo, hi = search.offsets_to_numpy(lo), search.offsets_to_numpy(hi)
    return [(int(h) << 32) | int(x) for x, h in zip(lo, hi)]


def assert_meets(found, rows_host, difficulties=None) -> None:
    """Every found nonce meets its row's target, or the raised one, by hashlib."""
    for i, nonce in enumerate(found):
        if nonce == MAX_U64:
            continue
        d = int(rows_host[i, search.DIFF_HI]) << 32 | int(rows_host[i, search.DIFF_LO])
        if difficulties is not None and difficulties[i] is not None:
            d = difficulties[i]
        block_hash = np.ascontiguousarray(rows_host[i, :8], dtype=np.uint32).tobytes()
        assert ref_value(nonce, block_hash) >= d, (i, f"{nonce:016x}")


def first_hits(rows, geo: dict, windows: int) -> list:
    """Each row's first hit offset in ``windows`` windows of ``geo`` from its
    base, by the search kernel, or None."""
    offs = search.offsets_to_numpy(cuda_kernel.cuda_search_chunk_batch(
        on_card(rows), **{**geo, "nblocks": geo["nblocks"] * windows}))
    return [None if o == search.SENTINEL else int(o) for o in offs]


def draw_hits(rng, geo: dict, target: int, count: int, lo: int, hi: int) -> list:
    """``count`` random (row, first hit offset) at ``target`` whose first
    hit lies in windows [lo, hi) of ``geo``."""
    window, got = cuda_kernel.window(**geo), []
    for _ in range(16):
        rows = np.stack([search.pack_params(rng.bytes(32), target, int(rng.integers(0, 1 << 63)))
                         for _ in range(2 * count)])
        got += [(r, o) for r, o in zip(rows, first_hits(rows, geo, hi))
                if o is not None and lo * window <= o]
        if len(got) >= count:
            return got[:count]
    pytest.fail(f"no seed gave {count} first hits in windows [{lo}, {hi})")


def strided_first_hits(rows, geo: dict, stride: int, steps: int, device=DEVICE) -> list:
    """Each row's first hit over ``steps`` windows ``stride`` apart, window
    by window through the search kernel → its nonce, or MAX_U64 where every
    window is dry: what the run loop must return without control."""
    first = [MAX_U64] * rows.shape[0]
    for k in range(steps):
        moved = np.stack([with_fields(r, base=(row_base(r) + k * stride) & MAX_U64)
                          for r in rows])
        offs = search.offsets_to_numpy(cuda_kernel.cuda_search_chunk_batch(
            on_card(moved, device), **geo))
        for i, off in enumerate(offs):
            if first[i] == MAX_U64 and off != search.SENTINEL:
                first[i] = (row_base(moved[i]) + int(off)) & MAX_U64
    return first


def hit_windows(rows, found, stride: int) -> list:
    """The window (of windows ``stride`` apart) each found nonce lies in."""
    return [((n - row_base(r)) & MAX_U64) // stride for r, n in zip(rows, found)
            if n != MAX_U64]


class TickClock:
    """Control stamps that advance 0.125 s a read, so the kernel's and the
    plain version's delivered latencies must agree."""

    def __init__(self):
        self.t = 0.0

    def time(self) -> float:
        self.t += 0.125
        return self.t


class ZeroClock:
    """Control stamps that never move: members polling from several threads
    read the clock in no fixed order, so every delivered latency is 0."""

    def time(self) -> float:
        return 0.0


class ScriptedControl(control.LaunchControl):
    """Fires each (k_min, action, row, arg) event once, at the first poll
    with k >= k_min, from inside the poll: the loop then fixes when it is
    delivered, so the kernel and the plain loop must see it alike."""

    def __init__(self, rows: int, events, *, clock=None, n_dev: int = 1):
        super().__init__(rows, clock=clock or TickClock(), n_dev=n_dev)
        self.events, self.fired = list(events), set()

    def fire(self, k: int) -> None:
        for i, (k_min, action, row, arg) in enumerate(self.events):
            if k >= k_min and i not in self.fired:
                self.fired.add(i)
                if action == "cancel":
                    self.cancel(row)
                elif action == "kill":
                    self.kill(row)
                elif action == "raise":
                    self.raise_difficulty(row, arg, epoch=1)
                else:
                    self.rebase(row, arg, epoch=2)

    def poll(self, dev, k, done):
        self.fire(k)
        return super().poll(dev, k, done)


class LockstepControl(ScriptedControl):
    """ScriptedControl for a fan of ``n`` members that poll in lockstep:
    every member meets at a barrier in its poll, member 0 fires the events,
    and all read after a second barrier, so each member sees each command at
    the same window in the kernel's launch and in the plain one. The rows
    need one that stays live to max_steps, so every member polls every
    block."""

    def __init__(self, rows: int, n: int, events):
        super().__init__(rows, events, clock=ZeroClock(), n_dev=n)
        self.barrier = threading.Barrier(n, timeout=120)

    def poll(self, dev, k, done):
        self.barrier.wait()
        if int(dev) == 0:
            self.fire(k)
        self.barrier.wait()
        return control.LaunchControl.poll(self, dev, k, done)


def bookkeeping(c) -> dict:
    """What a launch left in its LaunchControl, per (row, member). Fan
    members deliver from threads of their own, in no fixed order."""
    return {
        "polls": c.polls, "last_k": c.last_k, "done_at_k": sorted(c.done_at_k.items()),
        "delivered": sorted(c.delivered) if c.n_dev > 1 else list(c.delivered),
        "fields": [(c.effective_base(r, d), c.effective_difficulty(r, d),
                    c.effective_epoch(r, -1, d), c.applied_at_k(r, d))
                   for r in range(c.rows) for d in range(c.n_dev)],
        "difficulty": [c.effective_difficulty(r) for r in range(c.rows)],
    }


def run_pair(params, *, window: int, geo: dict, max_steps: int, poll_steps=None, events=(),
             active=None, stride=None) -> dict:
    """One launch of the run kernel and one of the plain run_loop_core on the
    same rows (and, with ``poll_steps``, the same scripted control), windows
    ``stride`` apart (None: contiguous) → per side its nonces, bookkeeping
    and counted (even, re-granted) windows. The kernel's launch moves its
    counters by one."""
    out = {}
    for side in ("kernel", "plain"):
        c = slot = None
        if poll_steps is not None:
            c = ScriptedControl(params.shape[0], events)
            slot = control.register(c)
        try:
            if side == "kernel":
                before = cuda_kernel.run_launches, cuda_kernel.run_strided_launches
                if slot is None:
                    lo, hi = runloop.search_run_batch(params, active, max_steps=max_steps,
                                                      stride=stride, **geo)
                else:
                    lo, hi = runloop.search_run_batch_controlled(
                        params, active, slot, max_steps=max_steps, poll_steps=poll_steps,
                        stride=stride, **geo)
                strided = stride is not None and stride != window
                assert (cuda_kernel.run_launches, cuda_kernel.run_strided_launches) == (
                    before[0] + 1, before[1] + strided)
            else:
                lo, hi = runloop.run_loop_core(
                    params, active, launch=runloop.plain_launch(window), window=stride or window,
                    max_steps=max_steps, poll_steps=poll_steps or 0,
                    control_poll=None if slot is None else runloop.make_control_poll(slot))
            found = nonces(lo, hi)
        finally:
            if slot is not None:
                control.release(slot)
        out[side] = {"nonces": found, "control": None if c is None else bookkeeping(c),
                     "grid": None if c is None else dict(c.grid_windows)}
    return out


def assert_same(pair: dict, rows_host) -> None:
    """Both loops gave the same nonces and bookkeeping, and every nonce
    meets its row's target."""
    kernel, plain = pair["kernel"], pair["plain"]
    assert kernel["nonces"] == plain["nonces"]
    assert kernel["control"] == plain["control"]
    assert_meets(kernel["nonces"], rows_host,
                 None if kernel["control"] is None else kernel["control"]["difficulty"])


def assert_planted(pair: dict, rows, want: dict) -> None:
    """Both loops returned each planted row's known first hit."""
    for i, off in want.items():
        nonce = (row_base(rows[i]) + off) & MAX_U64
        assert pair["kernel"]["nonces"][i] == pair["plain"]["nonces"][i] == nonce, i


def engine_geo(eng) -> dict:
    return dict(sublanes=eng.sublanes, iters=eng.iters, nblocks=eng.nblocks, group=eng.group)


@pytest.mark.cuda
@pytest.mark.parametrize("nblocks", [1, 3, 16])
def test_kernel_matches_plain_on_the_card(card, nblocks):
    params = on_card(seeded_rows())
    geo = dict(sublanes=8, iters=16, nblocks=nblocks, group=2)
    before = cuda_kernel.launches
    got = cuda_kernel.cuda_search_chunk_batch(params, **geo)
    assert cuda_kernel.launches == before + 1
    torch.cuda.synchronize()
    want = search.search_chunk_batch(params, chunk_size=cuda_kernel.window(**geo))
    assert torch.equal(got, want)
    single = cuda_kernel.cuda_search_chunk(params[2], sublanes=8, iters=16, group=2)
    assert int(single) == int(search.search_chunk(params[2], chunk_size=8 * 128 * 16))
    with pytest.raises(TypeError):
        cuda_kernel.cuda_search_chunk_batch(params.to(torch.int64), **geo)


#: ALU-pipe instructions per nonce that each kernel's scan loop may issue.
#: The ALU pipe sets the body's pace: it carries the XORs, rotr 63 and the
#: adds' low halves, whose carry only IADD3 makes; rotr 24 and 16 go to the
#: FMA pipe as IDP + IMAD (blake2b_search.cuh). Measured 1,324 (search) and
#: 1,325 (run) ALU- and 1,028 and 1,031 FMA-pipe instructions, against
#: 1,687 and 1,683 ALU with the plain rotations (PERF.md, kernel table).
SCAN_ALU_BUDGET = 1340


@pytest.mark.cuda
@pytest.mark.parametrize("name, kernel", [("search", "b2_search_kernel"),
                                          ("run", "b2_run_kernel")])
def test_scan_loop_keeps_its_pipe_budget(card, name, kernel):
    """The scan loop's SASS, as ``chip_smoke.py build`` counts it: within
    the ALU budget, the FMA pipe under the ALU pipe, no half-rate
    IMAD.HI or IMAD.WIDE (each costs the loop more than the ALU
    instruction it would replace, blake2b_search.cuh) and no spill; and
    at least the hash's least work (dpowbench.roofline), so the count
    covers the whole body. A source edit or a ptxas that moves work onto
    slower forms fails here, not as a slower benchmark."""
    from dpowbench import roofline

    chip_smoke = _chip_smoke()
    cuda_kernel.load_libraries()
    sass = chip_smoke.sass_int_instructions(cuda_kernel.library_path(name), kernel)
    fma = sum(n for op, n in sass["loop"].items() if op in chip_smoke.FMA_OPS)
    alu = sum(sass["loop"].values()) - fma
    assert alu <= SCAN_ALU_BUDGET, sass["loop"]
    assert fma <= alu + 150, sass["loop"]
    assert alu + fma >= roofline.INT_OPS_PER_HASH, sass["loop"]
    assert sass["half_rate_in_loop"] == 0
    assert sass["local_memory_ops_in_loop"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("windows", [1, 4, 16])
def test_kernel_matches_plain_at_the_engines_launch_shapes(card, windows):
    """16 planted rows at the GPU geometry: the first b rows for every padded
    batch size b the engine emits, over each run length it launches. The
    grid's blocks per row depend on the row count and the span, so each
    shape is its own check. At one window also nblocks=1, with the
    single-row wrapper on every row; at the longest a lone hard request, and
    the planted hits must land in several engine windows and the carry rows
    cross their boundaries."""
    from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend

    eng = TorchWorkBackend(device=DEVICE)
    assert windows in eng._step_counts()
    geo = dict(sublanes=eng.sublanes, iters=eng.iters, group=eng.group)
    rows = planted_rows(np.random.default_rng(2026))
    assert len(rows) == eng.max_batch
    params = on_card(pack(rows))

    def check(idx: list, nblocks: int) -> np.ndarray:
        sub = params[idx].contiguous()
        got = search.offsets_to_numpy(cuda_kernel.cuda_search_chunk_batch(
            sub, nblocks=nblocks, **geo))
        want = search.offsets_to_numpy(search.search_chunk_batch(
            sub, chunk_size=cuda_kernel.window(nblocks=nblocks, **geo)))
        assert np.array_equal(got, want), (idx, nblocks)
        for i, off in zip(idx, got):
            h, d, b = rows[i]
            if d == 0:
                assert off == 0, i
            elif d == MAX_U64:
                assert off == search.SENTINEL, i
            elif off != search.SENTINEL:
                assert ref_value(b + int(off), h) >= d, i
        return got

    for b in eng._batch_sizes():
        full = check(list(range(b)), eng.nblocks * windows)
    if windows == 1:
        one = check(list(range(len(rows))), 1)
        span1 = cuda_kernel.window(**geo)
        for i in range(len(rows)):
            k = int(search.offsets_to_numpy(cuda_kernel.cuda_search_chunk(params[i], **geo)))
            p = int(search.offsets_to_numpy(search.search_chunk(params[i], chunk_size=span1)))
            assert k == p == one[i], i
    if windows == eng.run_steps:
        check([len(rows) - 2], eng.nblocks * eng.run_steps)  # a lone hard request
        hit = {int(o) // eng.chunk for o in full[4:-1] if o != search.SENTINEL}
        assert len(hit) >= 3, hit
        for i, bound in ((2, 5 << 32), (3, 1 << 64)):
            assert rows[i][2] + int(full[i]) >= bound, i


@pytest.mark.cuda
def test_kernel_counts_what_rows_ran_and_stops_a_row_lowered_mid_launch(card):
    """With ``scanned`` the offsets stay the plain version's (and those of
    the launch without it, scanned == nullptr); a dry row counts exactly
    its span, a hit row at least its offset + 1. A RowStopper lowering one
    row's out word from its own stream while the kernel runs stops that
    row short of its span, and leaves every other row as it was."""
    params = on_card(seeded_rows())
    rows = params.shape[0]
    geo = dict(sublanes=8, iters=16, nblocks=3, group=2)
    span = cuda_kernel.window(**geo)
    bare = cuda_kernel.cuda_search_chunk_batch(params, **geo)
    out = torch.full((rows,), -1, dtype=torch.int32, device="cuda")
    scanned = torch.zeros(rows, dtype=torch.int32, device="cuda")
    assert cuda_kernel.cuda_search_chunk_batch(params, out=out, scanned=scanned, **geo) is out
    torch.cuda.synchronize()
    plain = search.search_chunk_batch(params, chunk_size=span)
    assert torch.equal(bare, plain) and torch.equal(out, plain)
    for off, n in zip(search.offsets_to_numpy(out), search.offsets_to_numpy(scanned)):
        assert n == span if off == search.SENTINEL else off + 1 <= n <= span

    # Four rows of 2^29 nonces: two hit early, two are dry; row 1 is
    # stopped ~30 ms in, about half way through its span (2^28 a row ran
    # to its end in under 30 ms once the body took the FMA pipe).
    rng = np.random.default_rng(16)
    hard = [(rng.bytes(32), 0xFFFC000000000000, int(rng.integers(0, 1 << 62))),
            (rng.bytes(32), MAX_U64, int(rng.integers(0, 1 << 62))),
            (rng.bytes(32), MAX_U64, int(rng.integers(0, 1 << 62))),
            (rng.bytes(32), 0xFFFC000000000000, (1 << 64) - 5000)]
    params = on_card(pack(hard))
    geo = dict(sublanes=32, iters=1024, nblocks=128, group=8)
    span = cuda_kernel.window(**geo)
    want = search.offsets_to_numpy(cuda_kernel.cuda_search_chunk_batch(params, **geo))
    out = torch.full((4,), -1, dtype=torch.int32, device="cuda")
    scanned = torch.zeros(4, dtype=torch.int32, device="cuda")
    stopper = cuda_kernel.RowStopper(out)
    cuda_kernel.cuda_search_chunk_batch(params, out=out, scanned=scanned, **geo)
    time.sleep(0.03)
    stopper.stop(1)
    stopper.drain()
    torch.cuda.synchronize()
    got, ran = search.offsets_to_numpy(out), search.offsets_to_numpy(scanned)
    assert got[1] == 0 and 0 < ran[1] < span
    assert ran[2] == span and got[2] == want[2] == search.SENTINEL
    for r in (0, 3):
        h, d, base = hard[r]
        assert got[r] == want[r] < span and ran[r] >= got[r] + 1
        assert ref_value(base + int(got[r]), h) >= d
        assert all(ref_value(base + o, h) < d for o in range(int(got[r])))
    one = search.search_chunk_batch(params[[0, 3]], chunk_size=span)
    assert search.offsets_to_numpy(one).tolist() == [got[0], got[3]]


#: Scripted commands over 2^22-nonce windows: (events on the 16 run_rows,
#: events on row 9 alone). A killed row stays dead through a later rebase.
HARDER = (1 << 64) - (1 << 39)  # expected first hit 2^25 offsets in
REBASE_TO = 0x2F1C55AA01234567
RUN_EVENTS = {
    "none": ([], []),
    "cancel_k2": ([(2, "cancel", 15, None), (2, "cancel", 12, None)], [(2, "cancel", 0, None)]),
    "raise_k0": ([(0, "raise", 6, HARDER)], [(0, "raise", 0, HARDER)]),
    "rebase_k1": ([(1, "rebase", 11, REBASE_TO)], [(1, "rebase", 0, REBASE_TO)]),
    "kill": ([(1, "kill", 14, None), (3, "rebase", 14, REBASE_TO)], [(1, "kill", 0, None)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("rows,events,poll_steps", [
    *[("seeded", "seeded", poll_steps) for poll_steps in (None, 1, 3)],
    *[(rows, "no_control", None) for rows in ("rows16", "rows1")],
    *[(rows, events, poll_steps) for rows in ("rows16", "rows1") for events in RUN_EVENTS
      for poll_steps in (1, 4)],
    ("rows16", "active_mask", None),
])
def test_run_kernel_matches_plain_on_the_card(card, rows, events, poll_steps):
    """The run kernel against the plain loop: the seeded rows at a small
    geometry over 11 windows (SEEDED_EVENTS when polled); and the 16
    run_rows, or row 9 alone, over five 2^22-nonce windows: no control,
    each scripted command at poll steps 1 and 4, and an active mask.
    Bit-equal nonces and identical LaunchControl bookkeeping."""
    active = None
    if rows == "seeded":
        host, geo, max_steps, script = seeded_rows(), dict(sublanes=8, iters=16), 11, SEEDED_EVENTS
    else:
        host, geo, max_steps = pack(run_rows(np.random.default_rng(2029))), CHECK_GEO, 5
        if rows == "rows1":
            host = host[9:10]
        if events == "active_mask":
            mask = np.ones(host.shape[0], dtype=bool)
            mask[[4, 9]] = False
            active = torch.from_numpy(mask).to(DEVICE)
        script = RUN_EVENTS.get(events, ([], []))[rows == "rows1"]
    params = on_card(host)
    pair = run_pair(params, window=cuda_kernel.window(**geo), geo=geo, max_steps=max_steps,
                    poll_steps=poll_steps, events=script, active=active)
    assert_same(pair, host)
    if rows == "seeded":
        with pytest.raises(TypeError):
            runloop.search_run_batch(params.to(torch.int64), None, max_steps=1, sublanes=8,
                                     iters=16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["engine_window", "rows2", "rows4", "rows8", "rows16",
                                  "split_span"])
def test_run_kernel_matches_plain_at_the_persistent_engines_shapes(card, case):
    """The run kernel against the plain loop at the persistent engine's own
    window, poll cadence and launch length. engine_window: one row whose
    first hit lies in windows 2-5. rowsB: each batch size the engine packs
    (it sets each row's share of the grid), with a row raised at k = 0 to a
    target it meets in windows 0-3, a dry row cancelled at k = 2, rows with
    first hits planted in windows 0-3 and a pad as the engine packs it, so
    both loops exit within four windows. split_span: polls 2^31 offsets (64
    windows) apart, which the kernel scans as two spans of 2^30, its span
    limit, with no poll between; the row's first hit lies in the second."""
    from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend

    eng = TorchWorkBackend(device=DEVICE, run_mode="persistent")
    geo, window = engine_geo(eng), eng.chunk
    rng = np.random.default_rng({"engine_window": 2030, "split_span": 2031}.get(case, 2040))
    pad = search.pack_params(bytes(32), 0, 0)

    def planted(target: int, count: int, windows: int) -> list:
        rows = np.stack([search.pack_params(rng.bytes(32), target, int(rng.integers(0, 1 << 63)))
                         for _ in range(count)])
        return [(r, o) for r, o in zip(rows, first_hits(rows, geo, windows)) if o is not None]

    if case == "engine_window":
        for _ in range(64):
            row = search.pack_params(rng.bytes(32), (1 << 64) - (1 << 38),
                                     int(rng.integers(0, 1 << 62)))[None]
            off = first_hits(row, geo, 16)[0]
            if off is not None and 2 * window <= off < 6 * window:
                break
        else:
            pytest.fail("no seed put a first hit in engine windows 2-5")
        host, want = row, {0: off}
        pair = run_pair(on_card(host), window=window, geo=geo, max_steps=8,
                        poll_steps=eng.control_poll_steps)
    elif case == "split_span":
        cut = 1 << 30
        split_poll = 2 * cut // window
        far = (1 << 64) - (1 << 64) // (2 * cut)  # first hit ~2 * cut in
        for _ in range(3):
            found = [(r, o) for r, o in planted(far, 24, split_poll - 1) if o >= cut + 2 * window]
            if found:
                break
        else:
            pytest.fail("no seed put a first hit in [cut + 2 windows, 2 * cut)")
        row, off = found[0]
        # No hit lies in [base, base + off), so from the later base the first
        # hit is at offset ``at``, in the second span's second window.
        at = cut + window + window // 7
        host, want = with_fields(row, base=(row_base(row) + off - at) & MAX_U64)[None], {0: at}
        pair = run_pair(on_card(host), window=window, geo=geo, max_steps=eng.persistent_steps,
                        poll_steps=split_poll)
    else:
        b = int(case[4:])
        hard = (1 << 64) - (1 << 64) // (2 * window)  # first hit ~2 windows in
        hits = planted(hard, 48, 4)[:1 + max(0, b - 3)]
        assert len(hits) == 1 + max(0, b - 3), "too few first hits in windows 0-3"
        (raised, off), dry = hits[0], search.pack_params(rng.bytes(32), MAX_U64, 7)
        host = np.stack([with_fields(raised, difficulty=0), dry]
                        + [r for r, _ in hits[1:]] + [pad] * (b > 2))
        want = {0: off, **{i: o for i, (_, o) in enumerate(hits[1:], start=2)}}
        pair = run_pair(on_card(host), window=window, geo=geo, max_steps=eng.persistent_steps,
                        poll_steps=eng.control_poll_steps,
                        events=[(0, "raise", 0, hard), (2, "cancel", 1, None)])
    assert_planted(pair, host, want)
    assert_same(pair, host)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["late_row", "padded2", "padded4", "padded8", "span_end"])
def test_run_kernel_regrants_the_windows_of_done_rows(card, case):
    """Launches whose rows finish spans apart, at the engine's poll cadence
    over 2^22-nonce windows. late_row: 15 rows pinned to hit in the first
    span and one 8-15 windows in; paddedB: that late job padded to B rows as
    the engine pads; span_end: a launch that ends at its span's end, its dry
    row live to the last window. Every row but the late ones is done after
    the first span, so the kernel must count that span's windows even and
    every later one re-granted, and both loops return each row's first hit."""
    from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend

    poll_steps = TorchWorkBackend(device=DEVICE, run_mode="persistent").control_poll_steps
    geo, window = CHECK_GEO, cuda_kernel.window(**CHECK_GEO)
    first_span = poll_steps * window
    easy = (1 << 64) - (1 << 64) // first_span  # first hit ~1 span in
    late_target = (1 << 64) - (1 << 64) // (8 * window)  # ~8 windows in
    pad = search.pack_params(bytes(32), 0, 0)
    rng = np.random.default_rng({"late_row": 2041, "span_end": 2042}.get(case, 2043))

    def pinned(hits):  # rows whose first hit is off % first_span, with that offset
        return [(with_fields(r, base=(row_base(r) + o - o % first_span) & MAX_U64), o % first_span)
                for r, o in hits]

    def spans(off):  # windows the launch runs to the end of the span holding off
        return (off // first_span + 1) * poll_steps

    if case == "span_end":
        early = pinned(draw_hits(rng, geo, easy, 2, 0, 4))
        mid, mid_off = draw_hits(rng, geo, late_target, 1, 2, 6)[0]
        dry = search.pack_params(rng.bytes(32), MAX_U64, int(rng.integers(0, 1 << 63)))
        rows = [early[0][0], early[1][0], mid, dry, pad]
        want = {0: early[0][1], 1: early[1][1], 2: mid_off}
        max_steps, grid = 8, (poll_steps, 8 - poll_steps)
    else:
        late, late_off = draw_hits(rng, geo, late_target, 1, 8, 16)[0]
        if case == "late_row":
            early = pinned(draw_hits(rng, geo, easy, 15, 0, 4))
            rows = [r for r, _ in early] + [late]
            want = {**{i: o for i, (_, o) in enumerate(early)}, 15: late_off}
        else:
            rows = [late] + [pad] * (int(case[6:]) - 1)
            want = {0: late_off}
        max_steps, grid = 32, (poll_steps, spans(late_off) - poll_steps)
    host = np.stack(rows)
    pair = run_pair(on_card(host), window=window, geo=geo, max_steps=max_steps,
                    poll_steps=poll_steps)
    assert_planted(pair, host, want)
    assert_same(pair, host)
    assert pair["kernel"]["grid"].get(0) == grid


@pytest.mark.cuda
@pytest.mark.parametrize("rows,poll_steps,stride_windows", [
    ("seeded", None, 4), ("seeded", 1, 4), ("seeded", 2, 3), ("seeded", None, 1),
    ("planted", None, 4), ("planted", 1, 4), ("planted", 2, 4), ("planted", 1, 1),
    ("engine", None, 4),
])
def test_strided_run_kernel_matches_plain_on_the_card(card, rows, poll_steps, stride_windows):
    """The run kernel's windows ``stride_windows`` apart against the plain
    loop: the seeded rows at a small geometry and the fan's 10 rows over
    2^22-nonce windows, with and without a scripted control; and at the
    engine's window, rows drawn until some first hits lie in strided window
    0 and some in window 1, where both loops must return the first hits the
    search kernel finds window by window."""
    if rows == "engine":
        from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend

        eng = TorchWorkBackend(device=DEVICE)
        geo, window = engine_geo(eng), eng.chunk
        stride, steps = stride_windows * window, 2
        rng = np.random.default_rng(2035)
        target = (1 << 64) - (1 << 64) // window
        for _ in range(8):
            host = np.stack([search.pack_params(rng.bytes(32), target,
                                                int(rng.integers(0, 1 << 63)))
                             for _ in range(eng.max_batch)])
            want = strided_first_hits(host, geo, stride, steps)
            if {0, 1} <= set(hit_windows(host, want, stride)):
                break
        else:
            pytest.fail("no seed put first hits in strided windows 0 and 1")
        pair = run_pair(on_card(host), window=window, geo=geo, max_steps=steps, stride=stride)
        assert pair["kernel"]["nonces"] == pair["plain"]["nonces"] == want
        return
    if rows == "seeded":
        host, geo, max_steps, events = seeded_rows(), dict(sublanes=8, iters=16), 11, SEEDED_EVENTS
    else:
        host, geo, max_steps = fan_rows()[1], CHECK_GEO, 6
        events = [(0, "raise", 4, (1 << 64) - (1 << 42)), (2, "cancel", 8, None)]
    window = cuda_kernel.window(**geo)
    pair = run_pair(on_card(host), window=window, geo=geo, max_steps=max_steps,
                    poll_steps=poll_steps, events=events, stride=stride_windows * window)
    assert_same(pair, host)


def plain_member_loops(stk, devs, window: int, stride: int, max_steps: int, slot=None,
                  poll_steps: int = 0) -> tuple:
    """The plain run_loop_core of every member on its own card, windows
    ``stride`` apart, each on a thread of its own polling ``slot`` as that
    member → (lo, hi) uint32[D, B]."""
    from tpu_dpow_torch.parallel import fan_search

    def member(i, d):
        lo, hi = runloop.run_loop_core(
            search.params_from_numpy(stk[i], d), None, launch=runloop.plain_launch(window),
            window=stride, max_steps=max_steps, poll_steps=poll_steps,
            control_poll=None if slot is None else runloop.make_control_poll(slot, dev=i))
        return search.offsets_to_numpy(lo), search.offsets_to_numpy(hi)

    out = fan_search._on_member_threads(member, devs, None)
    return np.stack([lo for lo, _ in out]), np.stack([hi for _, hi in out])


def engine_fan_rows(rng) -> np.ndarray:
    """6 rows whose first hit is ~2^25 offsets in (one engine window) and 2
    that never solve."""
    return np.stack(
        [search.pack_params(rng.bytes(32), (1 << 64) - (1 << 39), int(rng.integers(0, 1 << 63)))
         for _ in range(6)]
        + [search.pack_params(rng.bytes(32), MAX_U64 - 1, int(rng.integers(0, 1 << 63)))
           for _ in range(2)])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["seeded", "planted", "engine"])
def test_fan_functions_match_plain_on_the_cards(card, rows):
    """Over every visible card: fan_search_chunk_batch against one plain
    scan of the global window, fan_search_devices on caller-baked member
    bases against each member's plain scan, and fan_search_run (member
    windows strided by the member count, the host election) against the
    plain loop of every member. The seeded rows at a small geometry, the
    fan's rows over 2^22-nonce member windows, and rows that hit ~1 engine
    window in at the engine's geometry."""
    from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend
    from tpu_dpow_torch.parallel import fan_search

    devs = fan_search.fan_devices(-1, DEVICE)
    n = len(devs)
    if rows == "seeded":
        scan = run = seeded_rows()
        geo, max_steps = dict(sublanes=8, iters=16), 9
    elif rows == "planted":
        (scan, run), geo, max_steps = fan_rows(), CHECK_GEO, 6
    else:
        scan = run = engine_fan_rows(np.random.default_rng(2034))
        geo, max_steps = engine_geo(TorchWorkBackend(device=DEVICE)), 4
    window = cuda_kernel.window(**geo)
    before = cuda_kernel.launches
    got = fan_search.fan_search_chunk_batch(scan, devices=devs, chunk_per_shard=window, **geo)
    assert cuda_kernel.launches == before + n
    want = search.offsets_to_numpy(search.search_chunk_batch(on_card(scan, devs[0]),
                                                             chunk_size=n * window))
    assert np.array_equal(got, want)
    stacked = fan_search.stagger(scan, n, 1 << 40)
    got = fan_search.fan_search_devices(stacked, devices=devs, chunk_per_shard=window, **geo)
    want = np.stack([search.offsets_to_numpy(search.search_chunk_batch(
        on_card(stacked[i], d), chunk_size=window)) for i, d in enumerate(devs)])
    assert np.array_equal(got, want)
    lo, hi = fan_search.fan_search_run(run, devices=devs, chunk_per_shard=window,
                                       max_steps=max_steps, **geo)
    want_lo, want_hi = fan_search.elect(run, *plain_member_loops(
        fan_search.stagger(run, n, window), devs, window, n * window, max_steps))
    assert np.array_equal(lo, want_lo) and np.array_equal(hi, want_hi)
    assert_meets(nonces(lo, hi), run)


def controlled_fan_pair(stk, devs, *, window: int, stride: int, max_steps: int,
                        poll_steps: int, geo: dict, events) -> dict:
    """fan_search_run_controlled and the plain loop of every member on the
    same caller-baked rows, each under a LockstepControl scripted with
    ``events`` → per side each member's nonces, the bookkeeping and the
    counted (even, re-granted) windows by member."""
    from tpu_dpow_torch.parallel import fan_search

    n, out = len(devs), {}
    for side in ("kernel", "plain"):
        c = LockstepControl(stk.shape[1], n, events)
        slot = control.register(c)
        try:
            if side == "kernel":
                lo, hi = fan_search.fan_search_run_controlled(
                    stk, slot, devices=devs, chunk_per_shard=window, max_steps=max_steps,
                    poll_steps=poll_steps, stride=stride, **geo)
            else:
                lo, hi = plain_member_loops(stk, devs, window, stride, max_steps, slot, poll_steps)
        finally:
            control.release(slot)
        out[side] = {"members": [nonces(lo[i], hi[i]) for i in range(n)],
                     "lo_hi": (lo, hi), "control": bookkeeping(c), "grid": dict(c.grid_windows)}
    assert out["kernel"]["members"] == out["plain"]["members"]
    assert out["kernel"]["control"] == out["plain"]["control"]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["split", "interleave", "far_apart", "engine"])
def test_controlled_fan_matches_plain_member_by_member(card, case):
    """fan_search_run_controlled over every visible card against the plain
    loop of every member, members polling in lockstep: nonces bit-equal and
    every LaunchControl field per (row, member) identical. split and
    interleave: the engine's two policies (member windows contiguous, or
    strided by the member count) over 2^22-nonce windows, with a raise at
    k = 0, a per-member rebase at k = 1 and a cancel at k = 2. far_apart:
    windows 4 x members apart, three rows that hit in member 0's strided
    window 0 and one 6-11 windows later, so member 0 counts one even window
    and the rest re-granted. engine: the engine's window, strided 4 windows
    apart at poll steps 2, a raise at k = 0 and a never-solving row
    cancelled at k = 2; each member returns its rows' first hits."""
    from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend
    from tpu_dpow_torch.parallel import fan_search

    devs = fan_search.fan_devices(-1, DEVICE)
    n = len(devs)
    if case in ("split", "interleave"):
        geo, host = CHECK_GEO, fan_rows()[1]
        window = cuda_kernel.window(**geo)
        harder = (1 << 64) - (1 << 42)
        rebase_to = [int(x) for x in np.random.default_rng(2033).integers(0, 1 << 63, size=n)]
        events = [(0, "raise", 4, harder), (1, "rebase", 3, rebase_to), (2, "cancel", 8, None)]
        stk, stride = ((fan_search.stagger(host, n, 1 << 40), window) if case == "split"
                       else (fan_search.stagger(host, n, window), n * window))
        pair = controlled_fan_pair(stk, devs, window=window, stride=stride, max_steps=5,
                                   poll_steps=1, geo=geo, events=events)
        for i, member in enumerate(pair["kernel"]["members"]):
            assert_meets(member, stk[i], [harder if r == 4 else None for r in range(len(host))])
    elif case == "far_apart":
        geo = CHECK_GEO
        window = cuda_kernel.window(**geo)
        stride, steps = 4 * n * window, 12
        easy = (1 << 64) - (1 << 64) // (window // 2)
        late_target = (1 << 64) - (1 << 64) // (8 * window)
        rng = np.random.default_rng(2037)
        early, late = [], []
        for _ in range(16):
            cands = np.stack([search.pack_params(rng.bytes(32), easy if i < 8 else late_target,
                                                 int(rng.integers(0, 1 << 63)))
                              for i in range(16)])
            for row, nonce in zip(cands, strided_first_hits(cands, geo, stride, steps, devs[0])):
                w = ((nonce - row_base(row)) & MAX_U64) // stride
                if nonce != MAX_U64 and w == 0:
                    early.append((row, nonce))
                elif nonce != MAX_U64 and 6 <= w < steps:
                    late.append((row, nonce))
            if len(early) >= 3 and late:
                break
        else:
            pytest.fail("no seed put three first hits in strided window 0 and one in 6-11")
        far = early[:3] + late[:1]
        dry = search.pack_params(rng.bytes(32), MAX_U64, int(rng.integers(0, 1 << 63)))
        host = np.stack([r for r, _ in far] + [dry])
        pair = controlled_fan_pair(fan_search.stagger(host, n, window), devs, window=window,
                                   stride=stride, max_steps=steps, poll_steps=1, geo=geo,
                                   events=[])
        assert pair["kernel"]["members"][0] == [nonce for _, nonce in far] + [MAX_U64]
        assert pair["kernel"]["grid"].get(0) == (1, steps - 1)
    else:
        geo = engine_geo(TorchWorkBackend(device=DEVICE))
        window = cuda_kernel.window(**geo)
        stride, steps, raised_to = 4 * window, 4, (1 << 64) - (1 << 38)
        events = [(0, "raise", 0, raised_to), (2, "cancel", 6, None)]
        rng = np.random.default_rng(2038)
        # Drawn until member 0 has first hits both in window 0 and later.
        for _ in range(8):
            host = engine_fan_rows(rng)
            stk = fan_search.stagger(host, n, window)
            raised = stk.copy()
            raised[:, 0] = [with_fields(r, difficulty=raised_to) for r in stk[:, 0]]
            want = [strided_first_hits(raised[i], geo, stride, steps, d)
                    for i, d in enumerate(devs)]
            windows = set(hit_windows(stk[0], want[0], stride))
            if 0 in windows and max(windows) > 0:
                break
        else:
            pytest.fail("no seed put member 0's first hits in window 0 and a later one")
        pair = controlled_fan_pair(stk, devs, window=window, stride=stride, max_steps=steps,
                                   poll_steps=2, geo=geo, events=events)
        assert pair["kernel"]["members"] == want
        elected = nonces(*fan_search.elect(host, *pair["kernel"]["lo_hi"]))
        assert_meets(elected, host, [raised_to] + [None] * (len(host) - 1))


def mesh_rows(rng, n: int, window: int) -> np.ndarray:
    """8·n rows over ``window``-nonce member windows: rows whose expected
    first hit lies in member m's sub-range (m = row mod n), one whose ganged
    window crosses 2^64, pads, one dry row, and one that never solves (it
    keeps a controlled loop polling)."""
    def near(offset: float) -> int:  # difficulty whose expected first hit is ~offset in
        return (1 << 64) - int((1 << 64) / offset)

    spec = []
    for r in range(8 * n):
        h, base, kind = rng.bytes(32), int(rng.integers(0, 1 << 63)), r % 8
        if kind < 4:
            spec.append((h, near(((r % n) + 0.5) * window), base))
        elif kind == 4:
            spec.append((h, near(window), MAX_U64 - window // 2))
        elif kind == 5:
            spec.append((bytes(32) if r % 16 == 5 else h, 0, base))
        else:
            spec.append((h, MAX_U64 if kind == 6 else MAX_U64 - 1, base))
    return pack(spec)


@pytest.fixture
def plain_mesh(monkeypatch):
    """Calls a function with every mesh member running the search kernel's
    plain version on its card: the mesh function over plain members."""
    from tpu_dpow_torch.parallel import fan_search

    def plain(p_local, device, *, chunk_per_shard, **_geo):
        return search.search_chunk_batch(p_local, chunk_size=chunk_per_shard)

    def call(fn):
        with monkeypatch.context() as m:
            m.setattr(fan_search, "_local_scan", plain)
            return fn()

    return call


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["seeded", "planted"])
@pytest.mark.parametrize("batch_shards", [1, 2, 4])
def test_mesh_functions_match_plain_on_the_cards(card, plain_mesh, rows, batch_shards):
    """sharded_search_chunk_batch and sharded_search_run (with and without
    an active mask) over every visible card against the same functions over
    plain members: the seeded rows at a small geometry, and 8 rows per card
    over 2^22-nonce member windows with first hits in every member's
    sub-range, a 2^64 carry, pads, a dry and a never-solving row."""
    from tpu_dpow_torch.parallel import fan_search, mesh_search

    devs = fan_search.fan_devices(-1, DEVICE)
    if len(devs) % batch_shards:
        pytest.skip(f"{batch_shards} batch shards do not divide {len(devs)} cards")
    mesh = mesh_search.make_mesh(devs, batch_shards=batch_shards)
    if rows == "seeded":
        geo = dict(sublanes=8, iters=16)
        host = np.concatenate([seeded_rows(), seeded_rows()[1:2]])  # 8 rows: every split
    else:
        geo = CHECK_GEO
        host = mesh_rows(np.random.default_rng(2036), len(devs), cuda_kernel.window(**geo))
    window = cuda_kernel.window(**geo)
    chunk = lambda: mesh_search.sharded_search_chunk_batch(host, mesh=mesh,
                                                           chunk_per_shard=window, **geo)
    before = cuda_kernel.launches
    got = chunk()
    assert cuda_kernel.launches == before + len(devs)
    assert np.array_equal(got, plain_mesh(chunk))
    assert_meets([MAX_U64 if o == search.SENTINEL else (row_base(r) + int(o)) & MAX_U64
                  for r, o in zip(host, got)], host)
    active = np.arange(host.shape[0]) % 8 != 6
    for act in (None, active):
        run = lambda: mesh_search.sharded_search_run(host, act, mesh=mesh,
                                                     chunk_per_shard=window, max_steps=5, **geo)
        lo, hi = run()
        want_lo, want_hi = plain_mesh(run)
        assert np.array_equal(lo, want_lo) and np.array_equal(hi, want_hi)
        assert_meets(nonces(lo, hi), host)


@pytest.mark.cuda
def test_controlled_mesh_matches_plain_on_the_cards(card, plain_mesh):
    """sharded_search_run_controlled over every visible card, 8 rows per
    card over 2^22-nonce member windows, a raise at k = 0 and a cancel of
    the never-solving row at k = 2, polled every 2 windows, against the same
    function over plain members: bit-equal nonces, identical LaunchControl
    bookkeeping, and the cancelled row stops at the poll that cancels it."""
    from tpu_dpow_torch.parallel import fan_search, mesh_search

    devs = fan_search.fan_devices(-1, DEVICE)
    mesh = mesh_search.make_mesh(devs)
    window = cuda_kernel.window(**CHECK_GEO)
    host = mesh_rows(np.random.default_rng(2039), len(devs), window)
    harder = (1 << 64) - (1 << 36)

    def controlled():
        c = ScriptedControl(host.shape[0], [(0, "raise", 0, harder), (2, "cancel", 7, None)])
        slot = control.register(c)
        try:
            lo, hi = mesh_search.sharded_search_run_controlled(
                host, None, slot, mesh=mesh, chunk_per_shard=window, max_steps=5,
                poll_steps=2, **CHECK_GEO)
        finally:
            control.release(slot)
        return nonces(lo, hi), bookkeeping(c)

    found, book = controlled()
    assert (found, book) == plain_mesh(controlled)
    assert_meets(found, host, [harder] + [None] * (host.shape[0] - 1))
    assert found[7] == MAX_U64 and (7, 0) in dict(book["done_at_k"])

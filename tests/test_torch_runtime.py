"""The port's checkpoints and preemption guard (``repro_torch.runtime``)
against the reference's: every checkpoint and preemption case of
``tests/test_runtime.py`` on the port, and checkpoints crossing both
ways. Exact throughout (no tolerance): a checkpoint the reference writes
loads in the port with the same paths, shapes and bytes, and one the port
writes loads in the reference's ``load_checkpoint`` with the same paths,
shapes and bytes, with manifests of the same leaves, shapes and dtype
strings; a bf16 leaf round-trips bit for bit and reads back in the
reference as its raw ``|V2`` bytes."""

import json
import os
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ptqtp import PTQTPConfig as JPTQTPConfig
from repro.core.quantize_model import quantize_kernel as jquantize_kernel
from repro.runtime import checkpoint as jckpt
from repro_torch.artifacts.format import iter_tree_leaves
from repro_torch.core.ptqtp import PTQTPConfig
from repro_torch.core.quantize_model import QuantizedKernel, quantize_kernel
from repro_torch.runtime import (CheckpointManager, PreemptionGuard,
                                 latest_step, load_checkpoint,
                                 restore_to_device, save_checkpoint)

torch.set_num_threads(1)


def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(r.standard_normal((4, 8),
                                                           np.float32)),
                   "b": torch.from_numpy(r.standard_normal((8,), np.float32)),
                   "h": torch.from_numpy(r.standard_normal(
                       (3, 16), np.float32)).to(torch.bfloat16)},
        "opt": {"m": {"w": torch.zeros((4, 8)), "b": torch.zeros((8,))},
                "count": torch.tensor(7, dtype=torch.int32)},
        "step": torch.tensor(42, dtype=torch.int32),
    }


def _bytes(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.asarray(leaf).tobytes()


def _flat(tree):
    return dict(iter_tree_leaves(tree))


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = _tree()
        save_checkpoint(tmp_path, 42, tree)
        step, loaded, _ = load_checkpoint(tmp_path)
        assert step == 42
        a, b = _flat(tree), _flat(loaded)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k

    def test_quantized_kernel_roundtrip(self, tmp_path):
        w = torch.from_numpy(np.random.default_rng(1)
                             .standard_normal((64, 128), np.float32))
        qk = quantize_kernel(w, PTQTPConfig(group_size=32, t_max=3))
        save_checkpoint(tmp_path, 1, {"layer": {"kernel": qk}})
        _, loaded, _ = load_checkpoint(tmp_path)
        lk = loaded["layer"]["kernel"]
        assert isinstance(lk, QuantizedKernel)
        assert (lk.d_in, lk.d_out, lk.group_size) == (128, 64, 32)
        assert torch.equal(qk.t1p, lk.t1p) and torch.equal(qk.alpha, lk.alpha)

    def test_latest_points_to_newest(self, tmp_path):
        save_checkpoint(tmp_path, 1, _tree())
        save_checkpoint(tmp_path, 2, _tree(1))
        assert latest_step(tmp_path) == 2
        step, _, _ = load_checkpoint(tmp_path)
        assert step == 2

    def test_no_tmp_left_behind(self, tmp_path):
        save_checkpoint(tmp_path, 3, _tree())
        assert not [p for p in Path(tmp_path).iterdir() if ".tmp" in p.name]

    def test_extra_metadata(self, tmp_path):
        save_checkpoint(tmp_path, 5, _tree(), extra={"rng": [1, 2]})
        _, _, extra = load_checkpoint(tmp_path)
        assert extra == {"rng": [1, 2]}

    def test_manager_retention(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), interval_steps=1, keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, _tree(s))
        dirs = sorted(p.name for p in Path(tmp_path).glob("step_*"))
        assert dirs == ["step_00000003", "step_00000004"]
        step, _, _ = mgr.restore_latest()
        assert step == 4

    def test_manager_survives_a_stale_staging_dir(self, tmp_path):
        """A save killed mid-write leaves ``step_%08d.tmp_*`` behind; later
        saves still commit and prune committed steps only."""
        stale = Path(tmp_path) / "step_00000002.tmp_ab12"
        stale.mkdir()
        mgr = CheckpointManager(str(tmp_path), interval_steps=1, keep=2)
        for s in (1, 2, 3):
            mgr.save(s, _tree(s))
        dirs = sorted(p.name for p in Path(tmp_path).glob("step_*"))
        assert dirs == ["step_00000002", "step_00000002.tmp_ab12",
                        "step_00000003"]
        assert mgr.restore_latest()[0] == 3

    def test_should_save_interval(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), interval_steps=10)
        assert not mgr.should_save(5)
        assert mgr.should_save(10)
        assert not mgr.should_save(0)

    def test_missing_checkpoint_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            load_checkpoint(tmp_path)

    def test_restore_to_device_keeps_the_tree(self, tmp_path):
        save_checkpoint(tmp_path, 9, _tree())
        _, loaded, _ = load_checkpoint(tmp_path)
        moved = restore_to_device(loaded, "cpu")
        for k, v in _flat(loaded).items():
            assert torch.equal(_flat(moved)[k], v)


class TestCrossing:
    def test_reference_written_loads_with_the_same_bytes(self, tmp_path):
        """A checkpoint of the reference (f32, bf16 and int32 leaves, a
        quantized kernel) loads in the port: same paths, shapes, bytes;
        bf16 leaves as torch.bfloat16 by the manifest's dtype."""
        r = np.random.default_rng(3)
        w = r.standard_normal((128, 64), np.float32)
        tree = {"params": {"w": jnp.asarray(w),
                           "h": jnp.asarray(w[:3], jnp.bfloat16),
                           "q": {"kernel": jquantize_kernel(
                               jnp.asarray(w), JPTQTPConfig(group_size=32,
                                                            t_max=3))}},
                "step": jnp.int32(11)}
        jckpt.save_checkpoint(tmp_path, 11, tree)
        step, loaded, _ = load_checkpoint(tmp_path)
        assert step == 11
        assert loaded["params"]["h"].dtype == torch.bfloat16
        _, want, _ = jckpt.load_checkpoint(tmp_path)
        qk, jqk = loaded["params"].pop("q")["kernel"], \
            want["params"].pop("q")["kernel"]
        for f in ("t1p", "t2p", "alpha"):
            assert _bytes(getattr(qk, f)) == np.asarray(getattr(jqk, f)) \
                .tobytes()
        assert (qk.d_in, qk.d_out, qk.group_size) == \
            (jqk.d_in, jqk.d_out, jqk.group_size)
        a, b = _flat(loaded), _flat(want)
        assert list(a) == list(b)
        for k in a:
            assert tuple(a[k].shape) == b[k].shape
            assert _bytes(a[k]) == b[k].tobytes(), k

    def test_port_written_loads_in_the_reference(self, tmp_path):
        """The port's checkpoint, read by the reference's
        ``load_checkpoint``: the same paths, shapes and bytes (bf16 as
        ``|V2``), and a manifest of the same leaves as the reference
        writes for the same tree."""
        tree = _tree(5)
        save_checkpoint(tmp_path / "port", 42, tree, extra={"a": 1})
        step, got, extra = jckpt.load_checkpoint(tmp_path / "port")
        assert (step, extra) == (42, {"a": 1})
        assert got["params"]["h"].dtype.str == "|V2"
        a, b = _flat(tree), _flat(got)
        assert list(a) == list(b)
        for k in a:
            assert tuple(a[k].shape) == b[k].shape
            assert _bytes(a[k]) == b[k].tobytes(), k
        jtree = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16) if t.dtype == torch.bfloat16 else jnp.asarray(
            t.numpy()), tree)
        jckpt.save_checkpoint(tmp_path / "ref", 42, jtree, extra={"a": 1})
        mine, theirs = (json.loads((tmp_path / d / "step_00000042"
                                    / "manifest.json").read_text())
                        for d in ("port", "ref"))
        assert mine["leaves"] == theirs["leaves"]
        assert mine["leaves"]["params//h"]["dtype"] == "bfloat16"

    def test_bf16_leaf_round_trips_bit_for_bit(self, tmp_path):
        """Every bf16 bit pattern but the NaNs, stored as two raw bytes an
        element (``|V2``) and read back by the manifest's dtype."""
        bits = np.arange(1 << 16, dtype=np.uint16)
        bits = bits[(bits & 0x7F80) != 0x7F80]  # finite patterns only
        h = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
        save_checkpoint(tmp_path, 1, {"h": h})
        _, loaded, _ = load_checkpoint(tmp_path)
        assert loaded["h"].dtype == torch.bfloat16
        assert torch.equal(loaded["h"].view(torch.int16), h.view(torch.int16))
        with np.load(tmp_path / "step_00000001" / "host0000.npz") as z:
            assert z["h"].dtype.str == "|V2"
            assert z["h"].tobytes() == bits.tobytes()
        _, ref, _ = jckpt.load_checkpoint(tmp_path)
        assert ref["h"].tobytes() == bits.tobytes()


class TestPreemption:
    def test_programmatic_request(self):
        with PreemptionGuard() as g:
            assert not g.preempted
            g.request()
            assert g.preempted

    def test_signal_delivery(self):
        with PreemptionGuard(signals=(signal.SIGUSR1,)) as g:
            os.kill(os.getpid(), signal.SIGUSR1)
            assert g.wait(timeout=2.0)
            assert g.preempted

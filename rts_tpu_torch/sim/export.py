"""Result persistence: responses and CPI products to portable files
(counterpart of ``rts_tpu.sim.export``, the same keys and formats).

The reference accumulates responses in-memory and leaves persistence to
the external simulator's HDF5 export (SURVEY.md §0/§5).  Two formats with
one schema (one array per field plus JSON metadata):

  * compressed ``.npz`` (always available), and
  * ``.h5`` HDF5 when h5py is importable — the FERS/SOARS-ecosystem
    format; chosen automatically from the file extension.
"""

from __future__ import annotations

import json

import numpy as np
import torch

try:
    import h5py

    HAVE_HDF5 = True
except ImportError:  # pragma: no cover - h5py is present in the image
    h5py = None
    HAVE_HDF5 = False


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a NumPy array."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _is_h5(path: str) -> bool:
    return str(path).endswith((".h5", ".hdf5"))


def _save_arrays(path: str, arrays: dict) -> None:
    if _is_h5(path):
        if not HAVE_HDF5:
            raise RuntimeError("h5py not available for HDF5 export")
        with h5py.File(path, "w") as f:
            for k, v in arrays.items():
                v = np.asarray(v)
                if v.dtype.kind in ("U", "S"):  # strings -> HDF5 variable-length
                    f.create_dataset(k, data=v.astype("S"))
                else:
                    f.create_dataset(k, data=v, compression="gzip" if v.size > 64 else None)
        return
    np.savez_compressed(path, **arrays)


def _load_arrays(path: str) -> dict:
    if _is_h5(path):
        if not HAVE_HDF5:
            raise RuntimeError("h5py not available for HDF5 import")
        with h5py.File(path, "r") as f:
            out = {}
            for k in f:
                v = f[k][()]
                if isinstance(v, bytes):
                    v = v.decode()
                elif getattr(v, "dtype", None) is not None and v.dtype.kind == "S":
                    v = v.astype("U")
                out[k] = v
            return out
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def save_responses(path: str, world) -> None:
    """All receivers' responses -> one archive (.npz or .h5 by extension)."""
    fields = {"power": [], "time": [], "delay": [], "doppler": [], "phase": [], "noise_temperature": []}
    rx_index, tx_name, carrier = [], [], []
    for i, rx in enumerate(world.receivers):
        for resp in rx.responses:
            for p in resp.points:
                for k in fields:
                    fields[k].append(getattr(p, k))
                rx_index.append(i)
                tx_name.append(getattr(resp.transmitter, "name", "tx"))
                carrier.append(resp.wave.GetCarrier() if resp.wave else 0.0)
    meta = {
        "receivers": [rx.name for rx in world.receivers],
        "transmitters": [tx.name for tx in world.transmitters],
    }
    _save_arrays(
        path,
        dict(
            rx_index=np.asarray(rx_index, np.int32),
            tx_name=np.asarray(tx_name),
            carrier=np.asarray(carrier),
            meta=np.asarray(json.dumps(meta)),
            **{k: np.asarray(v) for k, v in fields.items()},
        ),
    )


def load_responses(path: str) -> dict:
    data = _load_arrays(path)
    out = {k: v for k, v in data.items() if k != "meta"}
    out["meta"] = json.loads(str(data["meta"]))
    return out


def save_cpi(path: str, out, times=None) -> None:
    """Traced CpiResult lanes (tensors on any device) -> .npz/.h5
    (checkpoint for long sweeps)."""
    arrays = {
        "power": _host(out.power),
        "doppler": _host(out.doppler),
        "delay": _host(out.delay),
        "received": _host(out.received),
        "agg_power": _host(out.agg.power),
        "agg_delay": _host(out.agg.delay),
        "agg_phase": _host(out.agg.phase),
        "agg_doppler": _host(out.agg.doppler),
        "agg_npath": _host(out.agg.npath),
        "agg_emit": _host(out.agg.emit),
        "agg_path_match": _host(out.agg.path_match),
        # f32 residual of agg_phase — add to agg_phase for double precision
        "agg_phase_lo": _host(out.agg.phase_lo),
    }
    if times is not None:
        arrays["times"] = _host(times)
    _save_arrays(path, arrays)


def load_cpi(path: str) -> dict:
    return _load_arrays(path)

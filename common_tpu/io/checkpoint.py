"""State serialization / checkpoint-resume for every latent-state family.

Reference analog: ``common:src/io/schema.proto`` +
``group_manager::serialize()`` — protobuf persistence of the assignment
vector, per-group counts, packed suffstats and hypers, surfaced in Python
as ``state.serialize()`` / ``deserialize``.  In the reference *every*
latent state serializes (mixturemodel, irm, lda all route through
group_manager); this module gives the same coverage for the rebuild's
state families:

  MixtureState (state.py), IRMState (relational/state.py), HDPState
  (topic/hdp.py), SVIPosterior (kernels/svi.py), and SMC particle sets
  (kernels/smc.py — a MixtureState with a leading particle axis plus
  log-weights, saved via ``extra``).

Vectorized design (SURVEY.md §5.4): each state is a registered-dataclass
pytree, so persistence is generic — data fields are walked (dicts /
tuples / arrays), each array leaf lands in an npz archive under its path,
static fields and the container skeleton go into a JSON header.  `extra`
carries anything needed for bit-exact resume (PRNG key, iteration
counter, SMC log-weights); checkpointed chains resume identically because
all randomness is fold_in-derived from the saved key.
"""

from __future__ import annotations

import dataclasses
import io as _io
import json
from typing import Any, Dict, Optional, Tuple

import jax
import numpy as np

from common_tpu import validator

_META_KEY = "__meta__"


def _state_types() -> Dict[str, type]:
    # late imports: io must not force the whole package graph at import
    from common_tpu.kernels.svi import SVIPosterior
    from common_tpu.relational.state import IRMState
    from common_tpu.state import MixtureState
    from common_tpu.topic.hdp import HDPState
    from common_tpu.topic.svi import LDAPosterior

    return {
        "MixtureState": MixtureState,
        "IRMState": IRMState,
        "HDPState": HDPState,
        "SVIPosterior": SVIPosterior,
        "LDAPosterior": LDAPosterior,
    }


def _is_key(v) -> bool:
    try:
        return jax.dtypes.issubdtype(v.dtype, jax.dtypes.prng_key)
    except Exception:
        return False


def _flatten_value(v, path: str, arrays: Dict[str, np.ndarray]):
    """Value → JSON skeleton; array leaves collected into `arrays`."""
    if isinstance(v, dict):
        return {
            "kind": "dict",
            "items": {
                k: _flatten_value(v[k], f"{path}.{k}", arrays)
                for k in sorted(v)
            },
        }
    if isinstance(v, (tuple, list)):
        return {
            "kind": "tuple" if isinstance(v, tuple) else "list",
            "items": [
                _flatten_value(x, f"{path}.{i}", arrays)
                for i, x in enumerate(v)
            ],
        }
    if _is_key(v):
        arrays[path] = np.asarray(jax.random.key_data(v))
        return {"kind": "prng_key"}
    arrays[path] = np.asarray(v)
    return {"kind": "array"}


def _rebuild_value(spec, path: str, z):
    import jax.numpy as jnp

    kind = spec["kind"]
    if kind == "dict":
        return {
            k: _rebuild_value(s, f"{path}.{k}", z)
            for k, s in spec["items"].items()
        }
    if kind in ("tuple", "list"):
        items = [
            _rebuild_value(s, f"{path}.{i}", z)
            for i, s in enumerate(spec["items"])
        ]
        return tuple(items) if kind == "tuple" else items
    if kind == "prng_key":
        return jax.random.wrap_key_data(jnp.asarray(z[path]))
    return jnp.asarray(z[path])


def serialize(state, extra: Optional[Dict[str, Any]] = None) -> bytes:
    """state → bytes (reference parity: state.serialize()).

    `state` may be any registered state dataclass (MixtureState, IRMState,
    HDPState, SVIPosterior); leading batch axes (chains, particles) ride
    along transparently since leaves are saved verbatim.
    """
    tname = type(state).__name__
    if tname not in _state_types():
        raise TypeError(
            f"cannot checkpoint {tname}; known state types: "
            f"{sorted(_state_types())}"
        )
    arrays: Dict[str, np.ndarray] = {}
    fields: Dict[str, Any] = {}
    static: Dict[str, Any] = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.metadata.get("static", False):
            static[f.name] = v
        else:
            fields[f.name] = _flatten_value(v, f"f.{f.name}", arrays)
    extra_spec = {}
    for k, v in (extra or {}).items():
        extra_spec[k] = _flatten_value(v, f"extra.{k}", arrays)
    meta = {
        "type": tname,
        "fields": fields,
        "static": jax.tree_util.tree_map(
            lambda x: x, static
        ),  # JSON-able by contract (names/flags/domain tuples)
        "extra": extra_spec,
        "version": 2,
    }
    buf = _io.BytesIO()
    np.savez(buf, **arrays, **{_META_KEY: np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)})
    return buf.getvalue()


def _tuplify(v):
    """JSON round-trips tuples as lists; static fields expect tuples."""
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


def deserialize(blob: bytes):
    """bytes → (state, extra); state type restored from the header."""
    with np.load(_io.BytesIO(blob)) as z:
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode())
        validator.validate_one_of(meta["version"], (2,), "checkpoint version")
        cls = _state_types()[meta["type"]]
        kwargs = {
            name: _rebuild_value(spec, f"f.{name}", z)
            for name, spec in meta["fields"].items()
        }
        for name, v in meta["static"].items():
            kwargs[name] = _tuplify(v)
        extra = {
            k: _rebuild_value(spec, f"extra.{k}", z)
            for k, spec in meta["extra"].items()
        }
    return cls(**kwargs), extra


def save(path: str, state, extra: Optional[Dict[str, Any]] = None):
    with open(path, "wb") as f:
        f.write(serialize(state, extra))


def load(path: str):
    with open(path, "rb") as f:
        return deserialize(f.read())

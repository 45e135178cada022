"""
Shared utilities: state stores, data path resolution, objtoolbox-compatible
JSON persistence, and re-exports of the host geometry kernel.

The reference's IPC substrate is file-backed shared-memory ``structstore``
stores (reference: library/tpl/util.py:310-333). Here the default substrate
is in-process stores with re-entrant locks — the whole planning pipeline
runs in one process, keeping device arrays resident — while preserving the
``store.lock(): ...`` working surface so applications read identically.
"""

import os
import re
import json
import time
import copy
import threading

import numpy as np

from tpl_tpu.ops import (        # noqa: F401  (re-exports, util.py:12-22)
    point_in_polygon,
    intersect_polygons,
    convex_hull,
    project,
    project_many,
    Projection,
    resample,
    interp_resampled_path,
    resample_path,
    path_segment,
    build_route,
    lerp,
    normalize_angle,
    short_angle_dist,
)


TO_SNAKE_CASE = re.compile(r'(?<!^)(?=[A-Z])')


_SNAP_ATOMS = (type(None), bool, int, float, complex, str, bytes,
               np.generic, type, type(len))


def snapshot(obj, _memo=None):
    """Fast deep copy for plain data graphs (the per-tick env snapshots).

    Semantically equivalent to ``copy.deepcopy`` for the object graphs the
    stores hold (numpy arrays, lists/dicts/tuples, plain data classes) but
    several times faster: arrays copy via ``ndarray.copy`` and plain
    objects rebuild via ``__new__`` + recursive ``__dict__`` copy, skipping
    the generic reduce protocol. Falls back to ``copy.deepcopy`` for
    anything exotic (custom ``__deepcopy__``, slots, extension types).
    """
    if isinstance(obj, _SNAP_ATOMS):
        return obj
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if _memo is None:
        _memo = {}
    oid = id(obj)
    hit = _memo.get(oid)
    if hit is not None:
        return hit[1]
    cls = obj.__class__
    if cls is list:
        out = []
        _memo[oid] = (obj, out)
        out.extend(snapshot(v, _memo) for v in obj)
        return out
    if cls is dict:
        out = {}
        _memo[oid] = (obj, out)
        for k, v in obj.items():
            out[k] = snapshot(v, _memo)
        return out
    if cls is tuple:
        return tuple(snapshot(v, _memo) for v in obj)
    if cls in (set, frozenset):
        return cls(snapshot(v, _memo) for v in obj)
    d = getattr(obj, "__dict__", None)
    if (d is not None and not hasattr(obj, "__deepcopy__")
            and not hasattr(cls, "__slots__")):
        out = cls.__new__(cls)
        _memo[oid] = (obj, out)
        od = out.__dict__
        for k, v in d.items():
            od[k] = snapshot(v, _memo)
        return out
    return copy.deepcopy(obj)


def to_snake_case(name):
    return TO_SNAKE_CASE.sub('_', name).lower()


def get_subclasses_recursive(cls):
    classes = []
    for c in cls.__subclasses__():
        classes += get_subclasses_recursive(c)
        classes.append(c)
    return classes


def runtime(func):
    """Store the last call duration on the wrapped function.
    (reference: library/tpl/util.py:54-67)"""

    def inner(*args, **kwargs):
        start = time.perf_counter()
        res = func(*args, **kwargs)
        inner.runtime = time.perf_counter() - start
        return res

    inner.runtime = 0.0
    return inner


# --- data paths -------------------------------------------------------

_REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "data")


def data_roots():
    """Ordered data roots: $TPL_TPU_DATA (a user's existing tpl data
    directory — the format is compatible), then the vendored repo data."""
    roots = []
    env = os.environ.get("TPL_TPU_DATA")
    if env:
        roots.append(env)
    roots.append(_REPO_DATA)
    return roots


def _default_data_path():
    return data_roots()[0]


PATH_DATA = _default_data_path()
PATH_SCENARIOS = os.path.join(PATH_DATA, "scenarios")
PATH_MAPS = os.path.join(PATH_DATA, "maps")
PATH_PARAMS = os.path.join(PATH_DATA, "params")


def resolve_data(kind, rel=""):
    """Resolve ``<data>/<kind>/<rel>`` across the layered data roots.

    ``PATH_<KIND>`` (which tests may monkeypatch) is searched first, then
    every root from :func:`data_roots`.  Returns the first existing path;
    if none exists, the primary path is returned so error messages point
    somewhere sensible.
    """
    primary = globals().get("PATH_" + kind.upper(),
                            os.path.join(PATH_DATA, kind))
    candidates = [primary]
    candidates += [os.path.join(r, kind) for r in data_roots()]
    for c in candidates:
        p = os.path.join(c, rel) if rel else c
        if os.path.exists(p):
            return p
    return os.path.join(primary, rel) if rel else primary


def list_data(kind):
    """Union of entries under <root>/<kind> across all data roots (the
    primary root wins name clashes)."""
    seen = {}
    primary = globals().get("PATH_" + kind.upper(),
                            os.path.join(PATH_DATA, kind))
    for base in [primary] + [os.path.join(r, kind) for r in data_roots()]:
        if not os.path.isdir(base):
            continue
        for name in sorted(os.listdir(base)):
            seen.setdefault(name, os.path.join(base, name))
    return seen


# --- bundle + stores --------------------------------------------------

class Bundle:
    """Open attribute namespace (otb.bundle equivalent)."""

    def __init__(self, **kwargs):
        self.__dict__.update(kwargs)

    def __iter__(self):
        return iter(self.__dict__.items())

    def __getitem__(self, k):
        return self.__dict__[k]

    def __setitem__(self, k, v):
        self.__dict__[k] = v

    def __contains__(self, k):
        return k in self.__dict__

    def keys(self):
        return self.__dict__.keys()

    def values(self):
        return self.__dict__.values()

    def items(self):
        return self.__dict__.items()


def get_obj_dict(obj):
    if isinstance(obj, dict):
        return obj
    return {k: v for k, v in vars(obj).items() if not k.startswith("_")}


class Store(Bundle):
    """Lockable attribute store (single-process structstore equivalent)."""

    def __init__(self, **kwargs):
        object.__setattr__(self, "_lock_obj", threading.RLock())
        super().__init__(**kwargs)

    def lock(self):
        return self._lock_obj

    def deepcopy(self):
        with self._lock_obj:
            return copy.deepcopy(Bundle(**{
                k: v for k, v in self.__dict__.items()
                if not k.startswith("_lock")}))

    def revalidate(self):
        pass


class StoreRegistry:
    """Named in-process store registry (util.py:310-333 analog)."""

    REGISTRY = {}
    _LOCK = threading.Lock()

    @staticmethod
    def get(path, *args, reinit=False, **kwargs):
        with StoreRegistry._LOCK:
            store = StoreRegistry.REGISTRY.get(path)
            if store is None:
                if os.environ.get("TPL_TPU_SHM") == "1":
                    from tpl_tpu.util.shm_store import ShmStore
                    store = ShmStore(path, reinit=reinit)
                else:
                    store = Store()
                StoreRegistry.REGISTRY[path] = store
            return store

    @staticmethod
    def clear():
        with StoreRegistry._LOCK:
            StoreRegistry.REGISTRY.clear()


class SharedObject:
    """Wrap any object with a lock; attribute access passes through.

    Equivalent working surface to make_class_shared (util.py:248-307).
    """

    def __init__(self, obj):
        object.__setattr__(self, "_obj", obj)
        object.__setattr__(self, "_lock_obj", threading.RLock())

    def lock(self):
        return self._lock_obj

    def revalidate(self):
        pass

    def unwrap(self):
        return self._obj

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_obj"), name)

    def __setattr__(self, name, value):
        setattr(object.__getattribute__(self, "_obj"), name, value)

    def __deepcopy__(self, memo=None):
        with self._lock_obj:
            return SharedObject(copy.deepcopy(self._obj))


# --- objtoolbox-compatible persistence --------------------------------

def _decode_node(node, extern_dir):
    if isinstance(node, dict):
        cls = node.get("__class__")
        if cls == "__extern__":
            p = os.path.join(extern_dir, node["path"] + ".npy")
            return np.load(p)
        if cls == "numpy.ndarray":
            # inline ndarray encoding (objtoolbox writes small arrays as
            # {"__class__": "numpy.ndarray", "dtype", "data"})
            return np.asarray(node.get("data", []),
                              dtype=node.get("dtype", "float64"))
        out = {}
        for k, v in node.items():
            if k == "__class__":
                continue
            out[k] = _decode_node(v, extern_dir)
        return out
    if isinstance(node, list):
        dec = [_decode_node(v, extern_dir) for v in node]
        if dec and all(isinstance(x, (int, float)) for x in dec):
            return np.asarray(dec, dtype=np.float64)
        if (dec and all(isinstance(x, list) for x in dec)
                and all(all(isinstance(y, (int, float)) for y in x)
                        for x in dec)):
            return np.asarray(dec, dtype=np.float64)
        return dec
    return node


def load_state_dict(path):
    """Load a state.json (+ extern arrays) into nested dicts/arrays.

    Compatible with the reference's objtoolbox save format
    (data/*/state.json + extern/*.npy).
    """
    state_file = os.path.join(path, "state.json")
    if not os.path.isfile(state_file):
        return None
    with open(state_file) as f:
        raw = json.load(f)
    return _decode_node(raw, os.path.join(path, "extern"))


def merge_into(obj, data):
    """Deep-merge a decoded dict into an object's matching attributes.

    Unknown keys are attached to Bundle/dict targets and skipped on typed
    objects (mirrors otb.merge tolerance for param-set drift).
    """
    if data is None:
        return obj
    open_ns = isinstance(obj, (Bundle, Store, dict))
    for k, v in (data.items() if isinstance(data, dict) else []):
        if isinstance(obj, dict):
            cur = obj.get(k)
        else:
            cur = getattr(obj, k, None)
        if isinstance(v, dict) and cur is not None and not isinstance(
                cur, (np.ndarray, int, float, str, bool, type(None))):
            merge_into(cur, v)
            continue
        if isinstance(v, dict) and cur is None and open_ns:
            b = Bundle()
            merge_into(b, v)
            v = b
        elif isinstance(v, dict):
            continue
        if cur is not None and isinstance(cur, bool):
            v = bool(v)
        elif cur is not None and isinstance(cur, int) and not isinstance(
                v, np.ndarray):
            try:
                v = int(v)
            except (TypeError, ValueError):
                pass
        if not open_ns and cur is None and not hasattr(obj, k):
            # tolerate parameter drift between param sets and code
            pass
        if isinstance(obj, dict):
            obj[k] = v
        else:
            try:
                setattr(obj, k, v)
            except AttributeError:
                pass
    return obj


def _encode_node(value):
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.floating, np.integer)):
        return value.item()
    if isinstance(value, (Bundle, Store)):
        return {k: _encode_node(v) for k, v in value.items()
                if k == "__tag__" or not k.startswith("_")}
    if isinstance(value, dict):
        return {k: _encode_node(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_encode_node(v) for v in value]
    if hasattr(value, "__dict__"):
        if hasattr(value, "__savestate__"):
            d = value.__savestate__()
        else:
            d = value.__dict__
        # __tag__ survives the private-key filter: the map-item loaders
        # dispatch their typed classes on it
        return {k: _encode_node(v) for k, v in d.items()
                if k == "__tag__" or not k.startswith("_")}
    return value


def save_state_dict(obj, path):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "state.json"), "w") as f:
        json.dump(_encode_node(obj), f, indent=2, default=str)

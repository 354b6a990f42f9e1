"""Pretrained-weight store: versioned, hash-checked parameter files (the
port of ``mxnet_tpu/gluon/model_zoo/model_store.py``, a copy: the port
imports nothing of the JAX package).

Parity: reference `python/mxnet/gluon/model_zoo/model_store.py:1`
(`short_hash`, `get_model_file`, `purge`, the `{name}-{hash}.params`
layout under `$MXNET_HOME/models`).  Nothing is downloaded: `publish()`
installs a parameter file into the store layout (computing and
registering its sha1), and `get_model_file()` resolves and
integrity-checks it as the reference does a downloaded file.  A JSON
index per store root replaces the reference's hard-coded `_model_sha1`
table, so published weights outlive the process.  The file format is
the JAX package's, so a store either package filled serves both.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

__all__ = ["get_model_file", "purge", "publish", "short_hash",
           "register_sha1", "data_dir"]

# name -> sha1 (reference _model_sha1 analog; extended by the store index)
_model_sha1 = {}


def data_dir():
    """$MXNET_HOME or ~/.mxnet (reference base.data_dir)."""
    return os.environ.get("MXNET_HOME",
                          os.path.join(os.path.expanduser("~"), ".mxnet"))


def _default_root():
    return os.path.join(data_dir(), "models")


def _index_path(root):
    return os.path.join(root, "index.json")


def _load_index(root):
    try:
        with open(_index_path(root)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_index(root, index):
    os.makedirs(root, exist_ok=True)
    with open(_index_path(root), "w") as f:
        json.dump(index, f, indent=1, sort_keys=True)


def register_sha1(name, sha1):
    """Register a model checksum (the reference's _model_sha1 table entry)."""
    _model_sha1[name] = sha1


def short_hash(name, root=None):
    """First 8 hex chars of the registered sha1 (reference short_hash).
    The per-root index wins over the process-global table."""
    sha1 = _load_index(root or _default_root()).get(name) \
        or _model_sha1.get(name)
    if sha1 is None:
        raise ValueError(
            "Pretrained model for %s is not available in this store. "
            "Publish weights first: "
            "model_store.publish(%r, <params-file>)" % (name, name))
    return sha1[:8]


def _sha1_of(path):
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def check_sha1(filename, sha1_hash):
    """True iff file content matches (reference gluon.utils.check_sha1)."""
    return _sha1_of(filename) == sha1_hash


def get_model_file(name, root=None):
    """Resolve the parameter file for `name`, verifying its sha1
    (reference get_model_file minus the download: offline store only).

    The per-root index wins over the process-global table: two roots may
    hold different published weights for the same model name."""
    root = os.path.expanduser(root or _default_root())
    sha1 = _load_index(root).get(name) or _model_sha1.get(name)
    if sha1 is None:
        raise ValueError(
            "Pretrained model for %s is not available (offline store at "
            "%s has no entry). Publish weights first with "
            "model_store.publish(%r, <params-file>, root=%r)"
            % (name, root, name, root))
    _model_sha1[name] = sha1
    file_path = os.path.join(root, "%s-%s.params" % (name, sha1[:8]))
    if not os.path.exists(file_path):
        raise ValueError(
            "Model file %s is missing (index knows %s). Re-publish the "
            "weights." % (file_path, name))
    if not check_sha1(file_path, sha1):
        raise ValueError(
            "Model file %s checksum mismatch — the file is corrupted; "
            "re-publish the weights." % file_path)
    return file_path


def publish(name, params_file, root=None):
    """Install `params_file` into the store under the versioned layout and
    register its hash (the offline replacement for the reference's
    download side: CI/users seed the store once, get_model(pretrained=True)
    works from then on)."""
    root = os.path.expanduser(root or _default_root())
    sha1 = _sha1_of(params_file)
    os.makedirs(root, exist_ok=True)
    dst = os.path.join(root, "%s-%s.params" % (name, sha1[:8]))
    if os.path.abspath(params_file) != os.path.abspath(dst):
        shutil.copyfile(params_file, dst)
    index = _load_index(root)
    index[name] = sha1
    _save_index(root, index)
    _model_sha1[name] = sha1
    return dst


def purge(root=None):
    """Remove every stored model file (reference purge)."""
    root = os.path.expanduser(root or _default_root())
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params"):
            os.remove(os.path.join(root, f))
    try:
        os.remove(_index_path(root))
    except OSError:
        pass

"""Fingerprint-grammar audit of the port: parse, prove injectivity,
validate files.

The port's autotune key is the JAX package's v7 key with the device the
pick is for appended: ``v7|op=..|...|nk=<n_chunks>|dev=<device name>``
(``kernels.autotune.Fingerprint.key``).  Nothing at runtime parses a key
back, so a grammar bug -- a field dropped from the template, a device
name that cannot be told apart from the fields around it, a stale cache
from an older grammar -- would surface as silently aliased picks, not an
error.  This pass closes that hole three ways, as
``repro.analysis.fingerprint_audit`` does:

* ``parse_key`` -- a strict grammar for the port's key; round-tripping
  ``parse_key(fp.key()) == fp`` proves the rendering is lossless, device
  names with spaces included.  Keys of the retired v1-v6 grammars raise
  ``StaleKeyError``; a JAX key (no ``|dev=``) is refused with a
  ``ValueError`` that names the difference.
* ``audit_injectivity`` -- over ops x reorders x shard counts x a sampled
  structure space (plus every structure-zoo meta) x the devices
  ``AUDIT_DEVICES``, distinct fingerprints render distinct keys and
  every key round-trips.
* ``audit_files`` -- the port's autotune cache
  (``$REPRO_TORCH_AUTOTUNE_CACHE``, ``{"version": 1, "entries": {key:
  {variant, ...}}, "shard_entries": {"shards|max=<M>|<key>": {n_shards,
  ...}}}``) must parse under the current grammar, with each cached
  variant a registered kernel.  The port commits no key-bearing artifact
  yet; the JAX package's ``benchmarks/BENCH_*.baseline.json`` hold JAX
  keys and are never read.

>>> from repro_torch.kernels import autotune
>>> fp = autotune._make_fingerprint(4, 4, (16, 16), 8, 25, 40, 512,
...                                 device="NVIDIA H100 80GB HBM3")
>>> parse_key(fp.key()) == fp
True
>>> parse_key("v5|op=spmm|nbr=4")  # doctest: +IGNORE_EXCEPTION_DETAIL
Traceback (most recent call last):
    ...
StaleKeyError: stale fingerprint grammar v5 (current: v7) in key ...
"""
from __future__ import annotations

import itertools
import json
import os
import re

from repro_torch.analysis.report import Finding

_KEY_RE = re.compile(
    r"v7\|op=(?P<op>[a-z_]+)\|nbr=(?P<nbr>\d+)\|nbc=(?P<nbc>\d+)"
    r"\|b=(?P<h>\d+)x(?P<w>\d+)\|nnzb=(?P<nnzb>\d+)\|pad=(?P<pad>\d+)"
    r"\|skew=(?P<skew>\d+)\|n=(?P<n>\d+)\|ro=(?P<ro>[A-Za-z0-9_]+)"
    r"\|ns=(?P<ns>\d+)\|mb=(?P<mb>\d+)\|nk=(?P<nk>\d+)"
    r"\|dev=(?P<dev>[^|]+)", re.S)

# shard-count cache entries: the device cap prefixed onto a full key
_SHARD_KEY_RE = re.compile(r"shards\|max=(?P<max>\d+)\|(?P<fp>v\d+\|.+)",
                           re.S)

_STALE_RE = re.compile(r"^v(\d+)\|")

_OPS = ("spmm", "sddmm", "attn")

# the devices the injectivity audit keys every sampled fingerprint for:
# the CPU and the card the port runs on
AUDIT_DEVICES = ("cpu", "NVIDIA H100 80GB HBM3")


class StaleKeyError(ValueError):
    """A key from a retired (v1-v6) fingerprint grammar."""


def parse_key(key: str):
    """Strict inverse of ``Fingerprint.key()`` -- returns the port's
    Fingerprint or raises (``StaleKeyError`` for old grammar versions,
    ``ValueError`` for a JAX key or anything else malformed)."""
    from repro_torch.kernels import autotune
    m = _KEY_RE.fullmatch(key)
    if m is None:
        sv = _STALE_RE.match(key)
        if sv and int(sv.group(1)) < 7:
            raise StaleKeyError(
                f"stale fingerprint grammar v{sv.group(1)} (current: v7) "
                f"in key {key!r} — regenerate: delete the stale autotune "
                f"cache (${autotune.CACHE_ENV}) and refresh it with "
                "Autotuner.tune")
        if "|dev=" not in key and _KEY_RE.fullmatch(key + "|dev=x"):
            raise ValueError(
                f"key {key!r} is the JAX package's v7 key: the port's key "
                "names its device (|dev=<name>), and a pick measured on a "
                "TPU never serves the card")
        raise ValueError(f"key {key!r} does not match the port's v7 "
                         "fingerprint grammar (...|nk=<n>|dev=<device>)")
    g = m.groupdict()
    return autotune.Fingerprint(
        n_block_rows=int(g["nbr"]), n_block_cols=int(g["nbc"]),
        block=(int(g["h"]), int(g["w"])), nnzb=int(g["nnzb"]),
        pad_bucket=int(g["pad"]), skew_bucket=int(g["skew"]),
        n_bucket=int(g["n"]), reorder=g["ro"], n_shards=int(g["ns"]),
        max_bpr=int(g["mb"]), op=g["op"], n_chunks=int(g["nk"]),
        device=g["dev"])


def parse_shard_key(key: str):
    """Strict inverse of ``autotune.shard_entry_key`` -- returns
    ``(max_shards, Fingerprint)`` or raises like ``parse_key``."""
    m = _SHARD_KEY_RE.fullmatch(key)
    if m is None:
        raise ValueError(f"key {key!r} does not match the shard-entry "
                         "grammar shards|max=<M>|<fingerprint>")
    return int(m.group("max")), parse_key(m.group("fp"))


def sample_fingerprints(devices=AUDIT_DEVICES):
    """Deterministic sample of the fingerprint space: every op family x
    reorder x shard count over a spread of structures, plus the realized
    metas of the launch verifier's structure zoo at two N widths, each
    keyed for every device of ``devices``."""
    from repro_torch.analysis import verify_launch
    from repro_torch.kernels import autotune
    fps = []
    for (dev, op, reorder, ns, nk, block, nbr, nnzb, pad, skew, n) in \
            itertools.product(
                devices, _OPS, ("identity", "jaccard"), (1, 4), (1, 4),
                ((16, 16), (32, 16)), (4, 16), (8, 64),
                (0, 35), (0, 120), (64, 512)):
        fps.append(autotune._make_fingerprint(
            nbr, nbr + 1, block, nnzb, pad, skew, n, reorder=reorder,
            n_shards=ns, max_bpr=max(1, nnzb // nbr), op=op, n_chunks=nk,
            device=dev))
    for case in verify_launch.structure_zoo():
        metas = case.meta.shard_metas if hasattr(case.meta, "shard_metas") \
            else (case.meta,)
        for m in metas:
            for dev, op, n in itertools.product(devices, _OPS, (64, 512)):
                fps.append(autotune.fingerprint(m, n, op=op, device=dev))
    return fps


def audit_injectivity(devices=AUDIT_DEVICES) -> list:
    """Prove no aliasing over the sampled space: distinct fingerprints
    -> distinct keys, and every key round-trips losslessly."""
    findings = []
    seen = {}
    for fp in sample_fingerprints(devices):
        key = fp.key()
        try:
            back = parse_key(key)
        except ValueError as e:
            findings.append(Finding("fingerprint-audit", "key-grammar", 0,
                                    f"key {key!r} failed to parse: {e}"))
            continue
        if back != fp:
            findings.append(Finding(
                "fingerprint-audit", "key-grammar", 0,
                f"key {key!r} is lossy: parsed back to {back}, not {fp}"))
        prev = seen.setdefault(key, fp)
        if prev != fp:
            findings.append(Finding(
                "fingerprint-audit", "key-grammar", 0,
                f"ALIASING: distinct fingerprints {prev} and {fp} render "
                f"the same key {key!r}"))
    return findings


def _iter_fingerprint_strings(obj, ctx=""):
    """Yield (context, key-string) for every ``"fingerprint"`` value in a
    nested JSON object."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k == "fingerprint" and isinstance(v, str):
                yield ctx, v
            else:
                yield from _iter_fingerprint_strings(v, f"{ctx}/{k}")
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _iter_fingerprint_strings(v, f"{ctx}[{i}]")


def audit_files(root: str) -> list:
    """Validate the port's autotune cache (``$REPRO_TORCH_AUTOTUNE_CACHE``).
    ``root``, the checkout (the JAX twin's argument), holds no key-bearing
    artifact of the port yet, so nothing under it is read."""
    from repro_torch.kernels import autotune
    findings = []
    paths = []
    cache = os.environ.get(autotune.CACHE_ENV)
    if cache and os.path.exists(cache):
        paths.append(cache)
    for path in paths:
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            findings.append(Finding("fingerprint-audit", path, 0,
                                    f"unreadable JSON: {e}"))
            continue
        for ctx, key in _iter_fingerprint_strings(data):
            try:
                parse_key(key)
            except ValueError as e:
                findings.append(Finding(
                    "fingerprint-audit", path, 0,
                    f"fingerprint at {ctx or '/'} invalid: {e}"))
        if isinstance(data, dict) and isinstance(data.get("entries"), dict):
            for key, entry in data["entries"].items():
                try:
                    parse_key(key)
                except ValueError as e:
                    findings.append(Finding("fingerprint-audit", path, 0,
                                            f"cache key invalid: {e}"))
                variant = (entry or {}).get("variant")
                v = autotune._REGISTRY.get(variant)
                if v is None or not v.is_kernel:
                    findings.append(Finding(
                        "fingerprint-audit", path, 0,
                        f"cached variant {variant!r} for {key!r} is not a "
                        "registered kernel — stale cache"))
        if isinstance(data, dict) and \
                isinstance(data.get("shard_entries"), dict):
            for key, entry in data["shard_entries"].items():
                try:
                    parse_shard_key(key)
                except ValueError as e:
                    findings.append(Finding("fingerprint-audit", path, 0,
                                            f"shard-entry key invalid: {e}"))
                ns = (entry or {}).get("n_shards")
                if not isinstance(ns, int) or ns < 1:
                    findings.append(Finding(
                        "fingerprint-audit", path, 0,
                        f"shard entry {key!r} has invalid n_shards={ns!r}"))
    return findings


def run_audit(root: str) -> list:
    """The CLI pass: grammar injectivity + committed-artifact validation."""
    return audit_injectivity() + audit_files(root)

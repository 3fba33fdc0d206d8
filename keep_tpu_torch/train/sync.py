"""Checkpoint sync to remote storage (counterpart of
``keep_tpu/train/sync.py``).

A child process runs ``remote_sync`` every N seconds, copying the checkpoint
directory to a local path (``shutil``) or to an fsspec URL (s3://, gs://,
...), and leaves out what is still being written: names holding ``latest``,
``.tmp`` files (``train/checkpoint.py`` writes each checkpoint to one) and
``-tmp`` directories.

The child is started with the ``spawn`` method: the trainer has
initialised CUDA and runs threads, and a forked child of such a process
may hang. ``_loop`` stays at module level so that it can be pickled.
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import shutil
import time


def _should_skip(name: str) -> bool:
    # a file still being written must not be copied half-done
    return "latest" in name or name.endswith(".tmp") or "-tmp" in name


def _walk(local_dir: str):
    """``os.walk`` that prunes the directories ``_should_skip`` names: the
    files inside a temporary directory carry no 'tmp' in their names."""
    for root, dirs, files in os.walk(local_dir):
        dirs[:] = [d for d in dirs if not _should_skip(d)]
        yield root, dirs, files


def sync_local(local_dir: str, remote_dir: str) -> bool:
    """Copies every file newer than its copy (or without one), each through
    a ``.tmp`` file moved into place."""
    os.makedirs(remote_dir, exist_ok=True)
    for root, _, files in _walk(local_dir):
        rel = os.path.relpath(root, local_dir)
        for fname in files:
            if _should_skip(fname):
                continue
            src = os.path.join(root, fname)
            dst_dir = os.path.join(remote_dir, rel) if rel != "." else remote_dir
            os.makedirs(dst_dir, exist_ok=True)
            dst = os.path.join(dst_dir, fname)
            if (not os.path.exists(dst)
                    or os.path.getmtime(src) > os.path.getmtime(dst)):
                # a copy cut short (the child is terminated at the end of
                # training) must not leave a newer, truncated file that the
                # final pass would then skip
                shutil.copy2(src, dst + ".tmp")
                os.replace(dst + ".tmp", dst)
    return True


def sync_fsspec(local_dir: str, remote_dir: str) -> bool:
    """Uploads through fsspec, skipping files whose remote copy has the
    same size (checkpoints do not change once written). False, logged, when
    fsspec is not installed."""
    try:
        import fsspec
    except ImportError:
        logging.error("fsspec unavailable for remote sync to %s", remote_dir)
        return False
    fs, _ = fsspec.core.url_to_fs(remote_dir)
    for root, _, files in _walk(local_dir):
        rel = os.path.relpath(root, local_dir)
        for fname in files:
            if _should_skip(fname):
                continue
            src = os.path.join(root, fname)
            dst = "/".join(x for x in [remote_dir.rstrip("/"),
                                       rel if rel != "." else "", fname] if x)
            try:
                if (fs.exists(dst)
                        and fs.info(dst).get("size") == os.path.getsize(src)):
                    continue
            except Exception:
                pass  # the remote state is unknown: upload
            # a file system with directories (file://, sftp) needs the
            # parent; object stores ignore this
            try:
                fs.makedirs(dst.rsplit("/", 1)[0], exist_ok=True)
            except Exception:
                pass
            fs.put(src, dst)
    return True


def remote_sync(local_dir: str, remote_dir: str,
                protocol: str = "auto") -> bool:
    """One sync pass; False, logged, on failure (a sync never stops
    training)."""
    try:
        if protocol == "local" or (protocol == "auto"
                                   and "://" not in remote_dir):
            return sync_local(local_dir, remote_dir)
        return sync_fsspec(local_dir, remote_dir)
    except Exception as e:
        logging.error("remote sync failed: %s", e)
        return False


def _loop(interval: int, local_dir: str, remote_dir: str, protocol: str):
    while True:
        time.sleep(interval)
        ok = remote_sync(local_dir, remote_dir, protocol)
        logging.info("remote sync %s", "ok" if ok else "FAILED")


def start_sync_process(interval: int, local_dir: str, remote_dir: str,
                       protocol: str = "auto") -> multiprocessing.Process:
    """The background sync child (daemon, ``spawn`` start method);
    ``.terminate()`` it to stop."""
    p = multiprocessing.get_context("spawn").Process(
        target=_loop, args=(interval, local_dir, remote_dir, protocol),
        daemon=True, name="keep-remote-sync")
    p.start()
    return p

"""The port's CIFAR fetch (``data/cifar.py``) against a local HTTP server,
with no outside network: a tiny archive in the CIFAR layout is fetched,
checked, extracted and loaded (arrays byte-equal to the JAX package's
``load_dataset`` of the same files); an md5 mismatch is retried, then
refused, and leaves no file behind; transient failures are retried and a
persistent one gives up after exactly ``attempts``; ``ensure_dataset_available``
downloads once under its lock (three concurrent callers, a leftover lock
file of a dead holder), releases the lock and keeps the file; a second
call with an unreachable server is a no-op; ``maybe_download`` turns a
failure into a warning.
"""

import fcntl
import functools
import hashlib
import io
import logging
import os
import pickle
import tarfile
import threading
from http.server import HTTPServer, SimpleHTTPRequestHandler

import numpy as np
import pytest

from simclr_pytorch_distributed_tpu.data import cifar as jax_cifar
from simclr_pytorch_distributed_tpu_torch.data import cifar
from torch_threads import limit_threads

limit_threads()

UNREACHABLE = "http://127.0.0.1:1"  # connection refused, on this host


def _tiny_archive(dataset, n=4):
    """A CIFAR tar.gz of ``n`` images a batch: ``(bytes, md5)``."""
    rng = np.random.default_rng(0)
    if dataset == "cifar10":
        members = [(f"cifar-10-batches-py/{name}", "labels", 10)
                   for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]]
    else:
        members = [(f"cifar-100-python/{s}", "fine_labels", 100) for s in ("train", "test")]
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for member, label_key, n_cls in members:
            payload = pickle.dumps({"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                                    label_key: rng.integers(0, n_cls, n).tolist()})
            info = tarfile.TarInfo(member)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
    data = buf.getvalue()
    return data, hashlib.md5(data).hexdigest()


class _Handler(SimpleHTTPRequestHandler):
    """Serves files; fails the first ``failures_left`` requests with 503."""

    failures_left = 0
    requests = 0

    def do_GET(self):
        cls = type(self)
        cls.requests += 1
        if cls.failures_left > 0:
            cls.failures_left -= 1
            self.send_error(503, "transient")
            return
        super().do_GET()

    def log_message(self, *args):
        pass


@pytest.fixture
def site(tmp_path):
    """``serve(dataset, failures=0) -> (url, md5)`` on 127.0.0.1."""
    servers = []

    def serve(dataset="cifar10", failures=0):
        root = tmp_path / f"site_{len(servers)}"
        root.mkdir()
        data, md5 = _tiny_archive(dataset)
        (root / cifar.CIFAR_ARCHIVES[dataset][0]).write_bytes(data)
        _Handler.failures_left, _Handler.requests = failures, 0
        server = HTTPServer(("127.0.0.1", 0), functools.partial(_Handler, directory=str(root)))
        thread = threading.Thread(target=server.serve_forever, args=(0.05,), daemon=True)
        thread.start()
        servers.append((server, thread))
        return f"http://127.0.0.1:{server.server_port}", md5

    yield serve
    for server, thread in servers:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


@pytest.mark.parametrize("dataset,n_train", [("cifar10", 20), ("cifar100", 4)])
def test_fetch_extract_load(site, tmp_path, dataset, n_train):
    url, md5 = site(dataset)
    dest = tmp_path / "data"
    marker = cifar.download_cifar(dataset, str(dest), base_url=url, md5=md5)
    assert os.path.isdir(marker) and os.path.basename(marker) == cifar.CIFAR_ARCHIVES[dataset][2]
    assert not [p for p in dest.iterdir() if p.name.startswith(".extract")]
    train, test, n_cls = cifar.load_dataset(dataset, str(dest))
    j_train, j_test, j_cls = jax_cifar.load_dataset(dataset, str(dest))
    assert n_cls == j_cls and train["images"].shape == (n_train, 32, 32, 3)
    for ours, theirs in ((train, j_train), (test, j_test)):
        np.testing.assert_array_equal(ours["images"], theirs["images"])
        np.testing.assert_array_equal(ours["labels"], theirs["labels"])
    # idempotent with no network: the extracted directory short-circuits
    assert cifar.download_cifar(dataset, str(dest), base_url=UNREACHABLE, md5=md5) == marker


def test_md5_mismatch_is_retried_then_refused(site, tmp_path, caplog):
    url, _ = site()
    dest = tmp_path / "data"
    with caplog.at_level(logging.WARNING):
        with pytest.raises(ValueError, match="md5 mismatch"):
            cifar.download_cifar("cifar10", str(dest), base_url=url, md5="0" * 32,
                                 backoff_base=0.01)
    assert len([r for r in caplog.records if "retrying" in r.getMessage()]) == 2
    assert _Handler.requests == cifar.DOWNLOAD_ATTEMPTS
    assert not list(dest.iterdir())  # neither the archive nor a partial file


def test_transient_failures_are_retried(site, tmp_path):
    url, md5 = site(failures=2)
    marker = cifar.download_cifar("cifar10", str(tmp_path / "data"), base_url=url, md5=md5,
                                  backoff_base=0.01)
    assert os.path.isdir(marker) and _Handler.failures_left == 0 and _Handler.requests == 3


def test_persistent_failure_gives_up_after_attempts(site, tmp_path):
    from urllib.error import HTTPError

    url, md5 = site(failures=99)
    with pytest.raises(HTTPError):
        cifar.download_cifar("cifar10", str(tmp_path / "data"), base_url=url, md5=md5,
                             backoff_base=0.01, attempts=3)
    assert _Handler.requests == 3
    assert not list((tmp_path / "data").iterdir())


def _point_at(monkeypatch, url, md5):
    fname, _, marker = cifar.CIFAR_ARCHIVES["cifar10"]
    monkeypatch.setattr(cifar, "CIFAR_BASE_URL", url)
    monkeypatch.setitem(cifar.CIFAR_ARCHIVES, "cifar10", (fname, md5, marker))
    return marker


def test_lock_flow_downloads_once(site, tmp_path, monkeypatch):
    url, md5 = site()
    marker = _point_at(monkeypatch, url, md5)
    dest = tmp_path / "data"
    errors = []

    def call():
        try:
            cifar.ensure_dataset_available("cifar10", str(dest))
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=call) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    assert (dest / marker).is_dir() and _Handler.requests == 1
    lock = dest / ".cifar10.download.lock"
    assert lock.exists()  # kept on purpose
    fd = os.open(lock, os.O_RDWR)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)  # released: does not block
        fcntl.flock(fd, fcntl.LOCK_UN)
    finally:
        os.close(fd)
    # with the directory there, nothing reaches the (now unreachable) server
    monkeypatch.setattr(cifar, "CIFAR_BASE_URL", UNREACHABLE)
    cifar.ensure_dataset_available("cifar10", str(dest))
    assert _Handler.requests == 1
    # other datasets and --no_download do nothing
    cifar.ensure_dataset_available("synthetic", str(tmp_path / "none"))
    cifar.ensure_dataset_available("cifar10", str(tmp_path / "none"), download=False)
    assert not (tmp_path / "none").exists()


def test_a_dead_holders_lock_file_blocks_nobody(site, tmp_path, monkeypatch):
    url, md5 = site()
    marker = _point_at(monkeypatch, url, md5)
    dest = tmp_path / "data"
    dest.mkdir()
    (dest / ".cifar10.download.lock").write_text("99999 0\n")  # no flock on it
    cifar.ensure_dataset_available("cifar10", str(dest))
    assert (dest / marker).is_dir()


def test_maybe_download_warns_on_failure(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(cifar, "CIFAR_BASE_URL", UNREACHABLE)
    with caplog.at_level(logging.WARNING):
        cifar.maybe_download("cifar10", str(tmp_path))
    assert any("could not download" in r.getMessage() for r in caplog.records)
    with pytest.raises(FileNotFoundError, match="cifar-10-batches-py"):
        cifar.load_dataset("cifar10", str(tmp_path))
    train, _, n_cls = cifar.load_dataset("cifar10", str(tmp_path), allow_synthetic_fallback=True)
    j_train, _, _ = jax_cifar.load_dataset("cifar10", str(tmp_path), allow_synthetic_fallback=True)
    assert n_cls == 10
    np.testing.assert_array_equal(train["images"], j_train["images"])

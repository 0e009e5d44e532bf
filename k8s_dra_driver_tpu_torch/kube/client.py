"""Minimal typed Kubernetes client: interface + in-memory fake + REST impl.

The port's copy of the reference module. No Kubernetes client library is
available, so this package provides the three pieces the driver needs,
dict-native (k8s wire shape):

- ``KubeClient``     — get/list/create/update/delete/watch on any resource
- ``FakeKubeClient`` — in-memory store with resourceVersions, watch
  streams and the apiserver's structural validation (``kube/schema.py``);
  the hermetic seam the control plane's tests write through
- ``RealKubeClient`` — thin REST client (in-cluster service account or
  kubeconfig), stdlib http only; a kubeconfig needs PyYAML, imported only
  when one is read

Objects are plain dicts; callers address resources with a ``GVR``
(group/version + plural), e.g. ``GVR("resource.k8s.io/v1alpha3",
"resourceslices")``.
"""

from __future__ import annotations

import abc
import copy
import dataclasses
import http.client
import itertools
import json
import logging
import os
import queue
import re
import ssl
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Iterator, Optional

from ..utils import faults
from ..utils.backoff import Backoff, TokenBucket, full_jitter
from .errors import (
    AlreadyExistsError,
    ApiError,
    ConflictError,
    NotFoundError,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class GVR:
    """GroupVersionResource: addresses a resource collection.

    ``api_version`` is "v1" for core or "group/version" otherwise;
    ``resource`` is the lowercase plural ("resourceslices").
    """

    api_version: str
    resource: str
    namespaced: bool = False

    @property
    def path_prefix(self) -> str:
        if "/" in self.api_version:
            return f"/apis/{self.api_version}"
        return f"/api/{self.api_version}"


# The resources this driver touches.
RESOURCE_SLICES = GVR("resource.k8s.io/v1alpha3", "resourceslices")
RESOURCE_CLAIMS = GVR("resource.k8s.io/v1alpha3", "resourceclaims", namespaced=True)
DEVICE_CLASSES = GVR("resource.k8s.io/v1alpha3", "deviceclasses")
NODES = GVR("v1", "nodes")
PODS = GVR("v1", "pods", namespaced=True)
EVENTS = GVR("v1", "events", namespaced=True)


def parse_label_selector(selector: str | None) -> dict[str, str]:
    """Parse "k=v,k2=v2" equality selectors (the only form we emit).

    Unsupported operators (!=, in, notin) raise rather than being silently
    mangled into their inverse — real API servers would honour them, and a
    fake that inverts their meaning is worse than one that refuses.
    """
    if not selector:
        return {}
    out = {}
    for part in selector.split(","):
        part = part.strip()
        if not part:
            continue
        if "!=" in part or re.search(r"\b(in|notin)\b", part):
            raise ValueError(
                f"unsupported label selector operator in {part!r}; "
                "only equality and existence are implemented"
            )
        if "=" in part:
            k, _, v = part.partition("=")
            out[k.strip()] = v.strip().lstrip("=")
        else:
            out[part] = None  # existence check
    return out


def matches_labels(obj: dict, selector: str | None) -> bool:
    wanted = parse_label_selector(selector)
    if not wanted:
        return True
    labels = (obj.get("metadata") or {}).get("labels") or {}
    for k, v in wanted.items():
        if k not in labels:
            return False
        if v is not None and labels[k] != v:
            return False
    return True


@dataclasses.dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED | ERROR
    object: dict


class Watch:
    """A cancellable stream of WatchEvents."""

    def __init__(self):
        self._q: "queue.Queue[Optional[WatchEvent]]" = queue.Queue()
        self._stopped = threading.Event()
        # Optional teardown hook (e.g. closing a streaming HTTP response
        # so a blocked reader thread unblocks immediately).
        self._on_stop: Optional[Callable[[], None]] = None

    def stop(self) -> None:
        if not self._stopped.is_set():
            self._stopped.set()
            self._q.put(None)
            if self._on_stop is not None:
                try:
                    self._on_stop()
                except Exception:
                    pass

    @property
    def stopped(self) -> bool:
        return self._stopped.is_set()

    def _emit(self, ev: WatchEvent) -> None:
        if not self._stopped.is_set():
            self._q.put(ev)

    def events(self, timeout: Optional[float] = None) -> Iterator[WatchEvent]:
        """Yield events until stopped; with a timeout, returns when idle."""
        while not self._stopped.is_set():
            try:
                ev = self._q.get(timeout=timeout)
            except queue.Empty:
                return
            if ev is None:
                return
            yield ev


class KubeClient(abc.ABC):
    """The API-server seam (role of client-go clientsets)."""

    @abc.abstractmethod
    def get(self, gvr: GVR, name: str, namespace: str = "") -> dict: ...

    @abc.abstractmethod
    def list(
        self,
        gvr: GVR,
        namespace: str = "",
        label_selector: str | None = None,
    ) -> list[dict]: ...

    @abc.abstractmethod
    def create(self, gvr: GVR, obj: dict, namespace: str = "") -> dict: ...

    @abc.abstractmethod
    def update(self, gvr: GVR, obj: dict, namespace: str = "") -> dict: ...

    @abc.abstractmethod
    def delete(self, gvr: GVR, name: str, namespace: str = "") -> None: ...

    @abc.abstractmethod
    def watch(
        self,
        gvr: GVR,
        namespace: str = "",
        label_selector: str | None = None,
    ) -> Watch: ...

    # -- conveniences shared by impls --------------------------------------

    def list_meta(
        self,
        gvr: GVR,
        namespace: str = "",
        label_selector: str | None = None,
    ) -> list[tuple[str, str]]:
        """(name, resourceVersion) pairs for a collection — the cheap
        change-detection probe behind the allocator's incremental
        inventory index: comparing signatures per solve must not pay for
        deep-copying 10k device specs. Default: derived from ``list()``
        (full cost); ``FakeKubeClient`` overrides with a copy-free scan."""
        out = []
        for obj in self.list(gvr, namespace, label_selector):
            md = obj.get("metadata") or {}
            out.append((md.get("name", ""), md.get("resourceVersion", "")))
        return out

    def api_group_versions(self, group: str) -> list[str]:
        """Versions the server serves for an API group, preferred first
        (k8s group discovery, GET ``/apis/<group>``). Empty when the group
        is not served. Default: unknown — callers fall back to their
        pinned default version."""
        return []

    def close(self) -> None:
        """Release client resources (stop watches, join poll threads).

        Default no-op: the fake client's watches are push-driven and own no
        threads. ``RealKubeClient`` overrides this.
        """

    def apply(self, gvr: GVR, obj: dict, namespace: str = "") -> dict:
        """Create-or-update by name (server-side-apply-lite)."""
        name = obj["metadata"]["name"]
        try:
            existing = self.get(gvr, name, namespace)
        except NotFoundError:
            return self.create(gvr, obj, namespace)
        merged = copy.deepcopy(obj)
        merged["metadata"]["resourceVersion"] = existing["metadata"].get(
            "resourceVersion", ""
        )
        return self.update(gvr, merged, namespace)


# ---------------------------------------------------------------------------
# Fake
# ---------------------------------------------------------------------------


class FakeKubeClient(KubeClient):
    """In-memory API server with resourceVersion + watch semantics."""

    def __init__(self):
        self._lock = threading.RLock()
        # (gvr.resource, namespace, name) -> object
        self._store: dict[tuple[str, str, str], dict] = {}
        self._rv = itertools.count(1)
        # (gvr.resource) -> list of (namespace-filter, selector, Watch)
        self._watches: list[tuple[str, str, Optional[str], Watch]] = []
        # Optional fault injection: callable(verb, gvr, name) -> Exception|None
        self.fault_injector: Optional[Callable[[str, GVR, str], Optional[Exception]]] = None
        # group -> served versions (preferred first). Tests shrink this to
        # impersonate one cluster generation: a 1.31 server is
        # {"resource.k8s.io": ["v1alpha3"]}, a 1.32+ one ["v1beta1"].
        # Requests addressed to an unserved group version 404, as the real
        # API server's would.
        self.served_api_versions: dict[str, list[str]] = {
            "resource.k8s.io": ["v1beta1", "v1alpha3"],
        }
        # Apply upstream structural validation (kube/schema.py) to every
        # resource.k8s.io write, the way a real apiserver would (422).
        # The hermetic answer to "FakeKubeClient happily stores shapes a
        # real cluster rejects". Off-switch for tests that deliberately
        # store minimal stubs.
        self.validate_schemas = True

    # -- helpers -----------------------------------------------------------

    def _key(self, gvr: GVR, namespace: str, name: str):
        return (gvr.resource, namespace if gvr.namespaced else "", name)

    def _maybe_fault(self, verb: str, gvr: GVR, name: str):
        # Chaos seam: the global fault registry fires before the per-client
        # injector, so env-armed schedules reach the fake API server too.
        faults.fire(f"kube.{verb}")
        if "/" in gvr.api_version:
            group, _, version = gvr.api_version.partition("/")
            served = self.served_api_versions.get(group)
            if served is not None and version not in served:
                raise NotFoundError(
                    f"the server could not find the requested resource "
                    f"({gvr.api_version} {gvr.resource}; served: {served})"
                )
        if self.fault_injector is not None:
            err = self.fault_injector(verb, gvr, name)
            if err is not None:
                raise err

    def _maybe_validate(self, gvr: GVR, obj: dict):
        if not self.validate_schemas:
            return
        if not gvr.api_version.startswith("resource.k8s.io/"):
            return
        from .errors import InvalidError
        from .schema import SchemaError, validate_for_resource

        try:
            # Dispatch on the collection, as the real apiserver does — an
            # object omitting 'kind' must not bypass validation.
            validate_for_resource(gvr.resource, obj)
        except SchemaError as e:
            raise InvalidError(str(e)) from e

    def _notify(self, gvr: GVR, ev_type: str, obj: dict):
        ns = (obj.get("metadata") or {}).get("namespace", "")
        for res, wns, selector, w in list(self._watches):
            if res != gvr.resource or w.stopped:
                continue
            if gvr.namespaced and wns and wns != ns:
                continue
            if not matches_labels(obj, selector):
                continue
            w._emit(WatchEvent(ev_type, copy.deepcopy(obj)))

    # -- KubeClient --------------------------------------------------------

    def get(self, gvr: GVR, name: str, namespace: str = "") -> dict:
        self._maybe_fault("get", gvr, name)
        with self._lock:
            obj = self._store.get(self._key(gvr, namespace, name))
            if obj is None:
                raise NotFoundError(f"{gvr.resource}/{name} not found")
            return copy.deepcopy(obj)

    def list(
        self,
        gvr: GVR,
        namespace: str = "",
        label_selector: str | None = None,
    ) -> list[dict]:
        self._maybe_fault("list", gvr, "")
        with self._lock:
            out = []
            for (res, ns, _), obj in sorted(self._store.items()):
                if res != gvr.resource:
                    continue
                if gvr.namespaced and namespace and ns != namespace:
                    continue
                if not matches_labels(obj, label_selector):
                    continue
                out.append(copy.deepcopy(obj))
            return out

    def create(self, gvr: GVR, obj: dict, namespace: str = "") -> dict:
        name = obj["metadata"]["name"]
        self._maybe_fault("create", gvr, name)
        self._maybe_validate(gvr, obj)
        with self._lock:
            key = self._key(gvr, namespace or obj["metadata"].get("namespace", ""), name)
            if key in self._store:
                raise AlreadyExistsError(f"{gvr.resource}/{name} already exists")
            stored = copy.deepcopy(obj)
            md = stored.setdefault("metadata", {})
            md["resourceVersion"] = str(next(self._rv))
            md.setdefault("uid", f"uid-{md['resourceVersion']}")
            if gvr.namespaced:
                md.setdefault("namespace", namespace)
            self._store[key] = stored
            self._notify(gvr, "ADDED", stored)
            return copy.deepcopy(stored)

    def update(self, gvr: GVR, obj: dict, namespace: str = "") -> dict:
        name = obj["metadata"]["name"]
        self._maybe_fault("update", gvr, name)
        self._maybe_validate(gvr, obj)
        with self._lock:
            key = self._key(gvr, namespace or obj["metadata"].get("namespace", ""), name)
            existing = self._store.get(key)
            if existing is None:
                raise NotFoundError(f"{gvr.resource}/{name} not found")
            rv = obj["metadata"].get("resourceVersion", "")
            if rv and rv != existing["metadata"]["resourceVersion"]:
                raise ConflictError(
                    f"{gvr.resource}/{name}: resourceVersion {rv} != "
                    f"{existing['metadata']['resourceVersion']}"
                )
            stored = copy.deepcopy(obj)
            stored["metadata"]["resourceVersion"] = str(next(self._rv))
            stored["metadata"].setdefault("uid", existing["metadata"].get("uid"))
            self._store[key] = stored
            self._notify(gvr, "MODIFIED", stored)
            return copy.deepcopy(stored)

    def delete(self, gvr: GVR, name: str, namespace: str = "") -> None:
        self._maybe_fault("delete", gvr, name)
        with self._lock:
            key = self._key(gvr, namespace, name)
            obj = self._store.pop(key, None)
            if obj is None:
                raise NotFoundError(f"{gvr.resource}/{name} not found")
            self._notify(gvr, "DELETED", obj)

    def list_meta(
        self,
        gvr: GVR,
        namespace: str = "",
        label_selector: str | None = None,
    ) -> list[tuple[str, str]]:
        # Same filters and fault site as list(), but no deep copies: the
        # point of the probe is to be cheap at 10k-device inventories.
        self._maybe_fault("list", gvr, "")
        with self._lock:
            out = []
            for (res, ns, _), obj in sorted(self._store.items()):
                if res != gvr.resource:
                    continue
                if gvr.namespaced and namespace and ns != namespace:
                    continue
                if not matches_labels(obj, label_selector):
                    continue
                md = obj.get("metadata") or {}
                out.append((md.get("name", ""), md.get("resourceVersion", "")))
            return out

    def watch(
        self,
        gvr: GVR,
        namespace: str = "",
        label_selector: str | None = None,
    ) -> Watch:
        self._maybe_fault("watch", gvr, "")
        w = Watch()
        with self._lock:
            # Seed with current state (informer-style list+watch).
            for obj in self.list(gvr, namespace, label_selector):
                w._emit(WatchEvent("ADDED", obj))
            self._watches.append((gvr.resource, namespace, label_selector, w))
        return w

    def api_group_versions(self, group: str) -> list[str]:
        return list(self.served_api_versions.get(group, []))


# ---------------------------------------------------------------------------
# Real REST client
# ---------------------------------------------------------------------------

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class _RelistNeeded(Exception):
    """Internal: the watch history was compacted (410 Gone) — resume
    requires a fresh list."""


@dataclasses.dataclass
class ExecAuthConfig:
    """users[].user.exec from a kubeconfig: an external credential plugin
    (gcloud's gke-gcloud-auth-plugin, aws-iam-authenticator, ...). The
    client-go ExecCredential protocol: run the command, read an
    ExecCredential JSON from stdout, use status.token or the client
    cert/key it returns."""

    command: str
    args: list = dataclasses.field(default_factory=list)
    env: dict = dataclasses.field(default_factory=dict)
    api_version: str = "client.authentication.k8s.io/v1"

    def run(self) -> dict:
        """Execute the plugin; returns the ExecCredential ``status``."""
        import subprocess

        env = dict(os.environ)
        env.update(self.env)
        # The protocol's handshake: tell the plugin which apiVersion we
        # speak and that no interactive terminal is available.
        env["KUBERNETES_EXEC_INFO"] = json.dumps({
            "kind": "ExecCredential",
            "apiVersion": self.api_version,
            "spec": {"interactive": False},
        })
        out = subprocess.run(
            [self.command, *self.args],
            env=env, capture_output=True, text=True, timeout=60,
        )
        if out.returncode != 0:
            raise RuntimeError(
                f"exec credential plugin {self.command!r} failed "
                f"(rc={out.returncode}): {out.stderr.strip()[:500]}"
            )
        try:
            cred = json.loads(out.stdout)
        except ValueError as e:
            raise RuntimeError(
                f"exec credential plugin {self.command!r} printed "
                "non-JSON output"
            ) from e
        if cred.get("kind") != "ExecCredential":
            raise RuntimeError(
                f"exec credential plugin {self.command!r} returned kind "
                f"{cred.get('kind')!r}, want ExecCredential"
            )
        return cred.get("status") or {}


def _b64_pem(data: str) -> str:
    import base64

    return base64.b64decode(data).decode()


@dataclasses.dataclass
class RestConfig:
    host: str
    token: str = ""
    ca_file: str = ""
    ca_data: str = ""            # PEM (kubeconfig certificate-authority-data)
    insecure: bool = False
    client_cert_file: str = ""
    client_key_file: str = ""
    client_cert_data: str = ""   # PEM (kubeconfig client-certificate-data)
    client_key_data: str = ""    # PEM (kubeconfig client-key-data)
    exec_auth: Optional[ExecAuthConfig] = None

    @classmethod
    def in_cluster(cls) -> "RestConfig":
        """In-cluster config from the mounted service account
        (role of rest.InClusterConfig, pkg/flags/kubeclient.go:80-84)."""
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        with open(os.path.join(SERVICE_ACCOUNT_DIR, "token")) as f:
            token = f.read().strip()
        return cls(
            host=f"https://{host}:{port}",
            token=token,
            ca_file=os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt"),
        )

    @classmethod
    def from_kubeconfig(cls, path: str = "") -> "RestConfig":
        """Kubeconfig loader (current-context; role of clientcmd,
        pkg/flags/kubeclient.go:85-89). Understands every auth shape the
        clusters this repo's own scripts create actually emit: bearer
        tokens, client cert/key as files OR inline base64 ``*-data``
        (kind writes these), and exec credential plugins (GKE)."""
        import yaml

        path = path or os.environ.get(
            "KUBECONFIG", os.path.expanduser("~/.kube/config")
        )
        with open(path) as f:
            cfg = yaml.safe_load(f)
        ctx_name = cfg.get("current-context", "")
        ctx = next(
            c["context"] for c in cfg["contexts"] if c["name"] == ctx_name
        )
        cluster = next(
            c["cluster"] for c in cfg["clusters"] if c["name"] == ctx["cluster"]
        )
        user = next(
            u["user"] for u in cfg["users"] if u["name"] == ctx["user"]
        )
        exec_auth = None
        if "exec" in user:
            ex = user["exec"] or {}
            exec_auth = ExecAuthConfig(
                command=ex.get("command", ""),
                args=list(ex.get("args") or []),
                env={
                    e["name"]: e["value"] for e in (ex.get("env") or [])
                },
                api_version=ex.get(
                    "apiVersion", "client.authentication.k8s.io/v1"
                ),
            )
        return cls(
            host=cluster["server"],
            token=user.get("token", ""),
            ca_file=cluster.get("certificate-authority", ""),
            ca_data=_b64_pem(cluster.get("certificate-authority-data", "")),
            insecure=bool(cluster.get("insecure-skip-tls-verify", False)),
            client_cert_file=user.get("client-certificate", ""),
            client_key_file=user.get("client-key", ""),
            client_cert_data=_b64_pem(user.get("client-certificate-data", "")),
            client_key_data=_b64_pem(user.get("client-key-data", "")),
            exec_auth=exec_auth,
        )

    @classmethod
    def auto(cls) -> "RestConfig":
        if os.path.exists(os.path.join(SERVICE_ACCOUNT_DIR, "token")):
            return cls.in_cluster()
        return cls.from_kubeconfig()


class RealKubeClient(KubeClient):
    """REST client over stdlib urllib; JSON wire format.

    Watches stream over chunked ``?watch=true`` HTTP (the informer
    pattern, imex.go:233-287): list to seed, then consume newline-
    delimited watch events with resourceVersion resume, bookmark
    handling, and relist-on-410. ``watch_mode="poll"`` keeps the old
    list-diff poller as a fallback for API servers without watch
    support. All verbs pass a client-side QPS/burst token bucket
    (client-go flowcontrol analog, pkg/flags/kubeclient.go:49-64 —
    same defaults: QPS 5, burst 10; qps<=0 disables).
    """

    def __init__(
        self,
        config: Optional[RestConfig] = None,
        poll_interval: float = 10.0,
        qps: float = 5.0,
        burst: int = 10,
        watch_mode: str = "stream",
        list_page_size: int = 500,
        overload_retries: int = 4,
        registry=None,
    ):
        if watch_mode not in ("stream", "poll"):
            raise ValueError(
                f"watch_mode must be 'stream' or 'poll', got {watch_mode!r}"
            )
        # API-traffic metrics (client-go rest_client_requests_total analog);
        # a throwaway registry when none is given keeps call sites branchless.
        from ..utils.metrics import Counter, Registry

        reg = registry if registry is not None else Registry()
        self._m_requests = Counter(
            "tpu_dra_kube_api_requests_total",
            "Kubernetes API requests by verb and outcome code",
            reg,
        )
        self._m_retries = Counter(
            "tpu_dra_kube_api_retries_total",
            "Kubernetes API retries by trigger (overload code, reauth, "
            "watch reconnect)",
            reg,
        )
        self.config = config or RestConfig.auto()
        self.poll_interval = poll_interval
        self.watch_mode = watch_mode
        # Chunked lists (limit/continue, the informer pager's chunk size —
        # client-go's default is 500); 0 fetches whole collections at once.
        self.list_page_size = list_page_size
        # How many times a verb retries a 429/503 before surfacing it.
        self.overload_retries = overload_retries
        self._limiter = TokenBucket(qps=qps, burst=burst)
        self._auth_lock = threading.Lock()
        self._exec_expiry: Optional[float] = None  # epoch seconds, or None
        self._cred_files: list[str] = []  # materialized cert/key temp files
        if self.config.exec_auth is not None:
            self._refresh_exec_credentials()
        self._ssl_ctx = self._make_ssl_ctx()
        self._watch_threads: list[threading.Thread] = []
        self._watches: list[Watch] = []

    def close(self) -> None:
        """Stop every watch this client started and join the poll threads.

        Idempotent. Without this, an orphaned poller keeps hitting the (by
        then dead) API server and logging failures for the life of the
        process.
        """
        for w in self._watches:
            w.stop()
        for t in self._watch_threads:
            t.join(timeout=5)
        self._watches.clear()
        self._watch_threads.clear()
        for path in self._cred_files:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._cred_files.clear()

    def __enter__(self) -> "RealKubeClient":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()

    def _make_ssl_ctx(self) -> Optional[ssl.SSLContext]:
        if not self.config.host.startswith("https"):
            return None
        if self.config.insecure:
            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        elif self.config.ca_data:
            ctx = ssl.create_default_context(cadata=self.config.ca_data)
        elif self.config.ca_file:
            ctx = ssl.create_default_context(cafile=self.config.ca_file)
        else:
            ctx = ssl.create_default_context()
        cert_file, key_file = self._client_chain_files()
        if cert_file:
            # mTLS: the client certificate IS the identity on kind/GKE
            # admin kubeconfigs (clientcmd analog: kubeclient.go:85-89).
            ctx.load_cert_chain(cert_file, key_file or None)
        return ctx

    def _client_chain_files(self) -> tuple[str, str]:
        """Client cert/key as file paths. Inline ``*-data`` PEM (what kind
        writes, and what exec plugins return) is materialized into 0600
        temp files — the ssl module loads chains from files only. Files
        from a previous materialization are removed first: load_cert_chain
        copies them into the context, so a superseded pair is pure leakage
        (one rotated key pair per exec refresh, forever)."""
        cfg = self.config
        for path in self._cred_files:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._cred_files.clear()
        if cfg.client_cert_data:
            import tempfile

            def _write(pem: str, suffix: str) -> str:
                fd, path = tempfile.mkstemp(prefix="kubecred-", suffix=suffix)
                os.write(fd, pem.encode())
                os.close(fd)
                os.chmod(path, 0o600)
                self._cred_files.append(path)
                return path

            cert = _write(cfg.client_cert_data, ".crt")
            key = (
                _write(cfg.client_key_data, ".key")
                if cfg.client_key_data else ""
            )
            return cert, key
        return cfg.client_cert_file, cfg.client_key_file

    # -- exec credential plugins -------------------------------------------

    def _refresh_exec_credentials(self) -> None:
        """Run the kubeconfig's exec plugin and absorb its ExecCredential:
        bearer token and/or client cert rotation."""
        status = self.config.exec_auth.run()
        if status.get("token"):
            self.config.token = status["token"]
        if status.get("clientCertificateData"):
            self.config.client_cert_data = status["clientCertificateData"]
            self.config.client_key_data = status.get("clientKeyData", "")
        exp = status.get("expirationTimestamp")
        self._exec_expiry = None
        if exp:
            import datetime

            try:
                self._exec_expiry = datetime.datetime.fromisoformat(
                    exp.replace("Z", "+00:00")
                ).timestamp()
            except ValueError:
                logger.warning(
                    "exec plugin returned unparseable expirationTimestamp "
                    "%r; credentials will not auto-refresh", exp,
                )

    def _maybe_refresh_exec(self) -> None:
        """Re-run the exec plugin shortly before its credential expires
        (client-go refreshes on expiry too; without this, long-lived
        watches outlive a GKE token within the hour).

        A FAILED refresh must not abort the caller's verb: the refresh
        fires 60s early precisely so the cached token is still good, so
        log, defer the next attempt (no once-per-request plugin stalls
        under the auth lock), and proceed with what we have. If the
        cached token really is dead, the 401 path below forces the issue.
        """
        if self.config.exec_auth is None or self._exec_expiry is None:
            return
        if time.time() <= self._exec_expiry - 60:
            return
        with self._auth_lock:
            if time.time() <= self._exec_expiry - 60:
                return
            try:
                self._refresh_exec_credentials()
                self._ssl_ctx = self._make_ssl_ctx()
            except Exception as e:
                logger.warning(
                    "exec credential refresh failed (%s); keeping cached "
                    "credentials and retrying in 30s", e,
                )
                self._exec_expiry = time.time() + 90  # next try in ~30s

    def _force_refresh_exec(self) -> None:
        """401-triggered re-exec (client-go re-runs the plugin on
        Unauthorized): the only refresh path when the plugin never
        returns an expirationTimestamp. Failures propagate — with the
        server rejecting the cached token, there is nothing to fall
        back to."""
        with self._auth_lock:
            self._refresh_exec_credentials()
            self._ssl_ctx = self._make_ssl_ctx()

    def _url(self, gvr: GVR, namespace: str, name: str = "", query: dict | None = None) -> str:
        parts = [self.config.host.rstrip("/"), gvr.path_prefix.lstrip("/")]
        if gvr.namespaced and namespace:
            parts += ["namespaces", namespace]
        parts.append(gvr.resource)
        if name:
            parts.append(name)
        url = "/".join(parts)
        if query:
            url += "?" + urllib.parse.urlencode(query)
        return url

    def _request(self, method: str, url: str, body: dict | None = None,
                 accept: str | None = None) -> dict:
        """One API verb, with overload retries: 429/503 responses are
        retried after the server's Retry-After (priority-and-fairness load
        shedding tells clients exactly when to come back; ignoring it turns
        one overloaded relist into a retry storm). Bounded — the error
        surfaces after ``overload_retries`` attempts."""
        attempts = 0
        reauthed = False
        while True:
            try:
                out = self._request_once(method, url, body, accept=accept)
                self._m_requests.inc(verb=method, code="2xx")
                return out
            except ApiError as e:
                self._m_requests.inc(verb=method, code=str(e.code))
                if (
                    e.code == 401
                    and self.config.exec_auth is not None
                    and not reauthed
                ):
                    # Token died without (or despite) an expiry hint:
                    # re-exec the plugin once and retry (client-go's
                    # Unauthorized handling).
                    reauthed = True
                    logger.warning(
                        "%s %s got 401; re-running exec credential plugin",
                        method, url.split("?")[0],
                    )
                    self._force_refresh_exec()
                    self._m_retries.inc(reason="reauth")
                    continue
                if (
                    e.code not in (429, 503)
                    or attempts >= self.overload_retries
                ):
                    raise
                attempts += 1
                self._m_retries.inc(reason=str(e.code))
                if e.retry_after is not None:
                    # Server-directed pacing is honored exactly.
                    delay = e.retry_after
                else:
                    # Client-derived delays get full jitter so a fleet of
                    # plugins hit by one overload wave decorrelates
                    # instead of retrying in lockstep.
                    delay = full_jitter(min(0.5 * (2 ** attempts), 10.0))
                delay = min(delay, 30.0)
                logger.warning(
                    "%s %s got %d (attempt %d/%d); retrying in %.1fs",
                    method, url.split("?")[0], e.code,
                    attempts, self.overload_retries, delay,
                )
                time.sleep(delay)

    def _request_once(self, method: str, url: str, body: dict | None = None,
                      accept: str | None = None) -> dict:
        self._maybe_refresh_exec()
        self._limiter.acquire()
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", accept or "application/json")
        if data is not None:
            req.add_header("Content-Type", "application/json")
        if self.config.token:
            req.add_header("Authorization", f"Bearer {self.config.token}")
        try:
            with urllib.request.urlopen(req, context=self._ssl_ctx, timeout=30) as resp:
                payload = resp.read()
                return json.loads(payload) if payload else {}
        except urllib.error.HTTPError as e:
            try:
                msg = e.read().decode(errors="replace")
            except (OSError, http.client.HTTPException):
                # The server reset (ConnectionResetError) or truncated
                # (IncompleteRead) the connection while we drained the
                # error body; the status code alone still types the error —
                # surfacing the read failure here would turn a clean 404
                # into an untyped crash.
                msg = ""
            if e.code == 404:
                raise NotFoundError(msg) from e
            if e.code == 409:
                # The API server uses 409 for both AlreadyExists (duplicate
                # create) and Conflict (stale resourceVersion); disambiguate
                # on the Status reason so fake and real clients agree.
                reason = ""
                try:
                    reason = json.loads(msg).get("reason", "")
                except ValueError:
                    pass
                if reason == "AlreadyExists":
                    raise AlreadyExistsError(msg) from e
                raise ConflictError(msg) from e
            retry_after = None
            raw = e.headers.get("Retry-After", "") if e.headers else ""
            if raw:
                try:
                    retry_after = float(raw)
                except ValueError:
                    pass  # HTTP-date form: fall back to client pacing
            raise ApiError(msg, code=e.code, retry_after=retry_after) from e

    def get(self, gvr: GVR, name: str, namespace: str = "") -> dict:
        # Chaos sites fire on the LOGICAL verb (kube.get/list/create/...)
        # in both the real and fake clients, so an env-armed drill spec
        # behaves identically against either — never on the HTTP method,
        # which would silently rename kube.update to kube.put here.
        faults.fire("kube.get")
        return self._request("GET", self._url(gvr, namespace, name))

    def api_group_versions(self, group: str) -> list[str]:
        """Group discovery (GET /apis/<group>): served versions, the
        server's preferredVersion first. Empty when the group is absent.
        Deliberately skips the overload-retry loop: re-discovery runs from
        latency-sensitive recovery paths (under the plugin's claim lock),
        and a failed discovery is itself recoverable — fail fast."""
        try:
            payload = self._request_once(
                "GET", f"{self.config.host.rstrip('/')}/apis/{group}"
            )
        except NotFoundError:
            return []
        preferred = (payload.get("preferredVersion") or {}).get("version", "")
        versions = [
            v.get("version", "")
            for v in payload.get("versions", [])
            if v.get("version")
        ]
        if preferred in versions:
            versions.remove(preferred)
            versions.insert(0, preferred)
        return versions

    def _list_raw(
        self,
        gvr: GVR,
        namespace: str = "",
        label_selector: str | None = None,
    ) -> dict:
        """Full list response (items + list metadata.resourceVersion),
        assembled from limit/continue chunks (the informer pager: one giant
        list of hundreds of slices is exactly what falls over first at the
        64-chip scale the allocator handles; chunking bounds each response).
        The apiserver serves every chunk from the first chunk's snapshot,
        so the assembled list is consistent and the final page's
        resourceVersion is the resume point."""
        base: dict = {}
        if label_selector:
            base["labelSelector"] = label_selector
        if self.list_page_size > 0:
            base["limit"] = str(self.list_page_size)
        items: list[dict] = []
        cont = ""
        while True:
            q = dict(base)
            if cont:
                q["continue"] = cont
            try:
                out = self._request(
                    "GET", self._url(gvr, namespace, query=q or None)
                )
            except ApiError as e:
                if e.code == 410 and cont:
                    # Continue token outlived the etcd compaction window
                    # (slow page sequence, e.g. under 429 throttling). The
                    # pager contract: restart as one unpaged list —
                    # partial pages are from a dead snapshot and must be
                    # discarded, not stitched.
                    logger.warning(
                        "continue token for %s expired; retrying as one "
                        "unpaged list", gvr.resource,
                    )
                    q = {k: v for k, v in base.items() if k != "limit"}
                    return self._request(
                        "GET", self._url(gvr, namespace, query=q or None)
                    )
                raise
            items.extend(out.get("items", []))
            cont = (out.get("metadata") or {}).get("continue", "")
            if not cont:
                break
        out["items"] = items
        return out

    def list(
        self,
        gvr: GVR,
        namespace: str = "",
        label_selector: str | None = None,
    ) -> list[dict]:
        faults.fire("kube.list")
        return self._list_raw(gvr, namespace, label_selector).get("items", [])

    # Content negotiation for metadata-only lists: the apiserver
    # transcodes any resource list to meta.k8s.io PartialObjectMetadata
    # when asked — names + resourceVersions without the (large) specs.
    # The trailing plain type is the fallback for servers/proxies that
    # ignore the negotiation: they return full objects, which the item
    # loop below handles identically (metadata is metadata either way).
    _META_ACCEPT = (
        "application/json;as=PartialObjectMetadataList;"
        "g=meta.k8s.io;v=v1,application/json"
    )

    def list_meta(
        self,
        gvr: GVR,
        namespace: str = "",
        label_selector: str | None = None,
    ) -> list[tuple[str, str]]:
        """Change-detection probe for the allocator's incremental index:
        a metadata-only list (PartialObjectMetadataList), so polling for
        slice deltas does not re-download 10k device specs per solve.
        Any failure falls back to the base full-list derivation — the
        probe must never be less available than list() itself."""
        faults.fire("kube.list")
        query: dict = {}
        if label_selector:
            query["labelSelector"] = label_selector
        try:
            out = self._request(
                "GET", self._url(gvr, namespace, query=query or None),
                accept=self._META_ACCEPT,
            )
            return [
                ((item.get("metadata") or {}).get("name", ""),
                 (item.get("metadata") or {}).get("resourceVersion", ""))
                for item in out.get("items", [])
            ]
        except ApiError:
            return super().list_meta(gvr, namespace, label_selector)

    def create(self, gvr: GVR, obj: dict, namespace: str = "") -> dict:
        faults.fire("kube.create")
        return self._request("POST", self._url(gvr, namespace), obj)

    def update(self, gvr: GVR, obj: dict, namespace: str = "") -> dict:
        faults.fire("kube.update")
        return self._request(
            "PUT", self._url(gvr, namespace, obj["metadata"]["name"]), obj
        )

    def delete(self, gvr: GVR, name: str, namespace: str = "") -> None:
        faults.fire("kube.delete")
        self._request("DELETE", self._url(gvr, namespace, name))

    def watch(
        self,
        gvr: GVR,
        namespace: str = "",
        label_selector: str | None = None,
    ) -> Watch:
        faults.fire("kube.watch")
        if self.watch_mode == "stream":
            return self._watch_stream(gvr, namespace, label_selector)
        return self._watch_poll(gvr, namespace, label_selector)

    # -- streaming watch ---------------------------------------------------

    def _relist(self, gvr, namespace, label_selector, known, w):
        """List, diff against ``known`` (name -> resourceVersion), emit
        the delta, and return the list resourceVersion to resume from.

        Used both to seed a fresh watch (known={}) and to recover from a
        410 Gone (the server compacted history past our resumeRV): the
        informer relist — consumers see a consistent event stream either
        way.
        """
        out = self._list_raw(gvr, namespace, label_selector)
        seen: dict[str, str] = {}
        for obj in out.get("items", []):
            name = obj["metadata"]["name"]
            rv = obj["metadata"].get("resourceVersion", "")
            seen[name] = rv
            if name not in known:
                w._emit(WatchEvent("ADDED", obj))
            elif known[name] != rv:
                w._emit(WatchEvent("MODIFIED", obj))
        for name in set(known) - set(seen):
            w._emit(WatchEvent(
                "DELETED", {"metadata": {"name": name, "namespace": namespace}}
            ))
        known.clear()
        known.update(seen)
        list_rv = (out.get("metadata") or {}).get("resourceVersion", "")
        if not list_rv and seen:
            # Servers always set list RV; belt-and-braces fallback. RVs are
            # opaque per the API contract — only compare ones that look
            # numeric (every real apiserver's are), and when none do,
            # return "" so the next connect watches from "current" instead
            # of poisoning the loop with a ValueError (which the outer
            # watch loop would treat as a stream failure, relisting
            # forever).
            numeric = [v for v in seen.values() if v and v.isdigit()]
            list_rv = max(numeric, key=int) if numeric else ""
        return list_rv

    def _watch_stream(self, gvr, namespace, label_selector) -> Watch:
        w = Watch()

        def _stream():
            known: dict[str, str] = {}
            rv = ""
            backoff = Backoff(initial=0.2, cap=max(self.poll_interval, 1.0),
                              jitter=True)
            while not w.stopped:
                try:
                    if not rv:
                        rv = self._relist(gvr, namespace, label_selector, known, w)
                    rv = self._consume_stream(
                        gvr, namespace, label_selector, rv, known, w
                    )
                    backoff.reset()
                except _RelistNeeded:
                    rv = ""          # 410: resume via fresh list
                    backoff.reset()
                except Exception as e:
                    if w.stopped:
                        break
                    delay = backoff.next_delay()
                    self._m_retries.inc(reason="watch-reconnect")
                    logger.warning(
                        "watch stream %s failed (%s); reconnecting in %.1fs",
                        gvr.resource, e, delay,
                    )
                    w._stopped.wait(delay)

        t = threading.Thread(
            target=_stream, daemon=True, name=f"watch-{gvr.resource}"
        )
        t.start()
        self._watch_threads.append(t)
        self._watches.append(w)
        return w

    def _consume_stream(self, gvr, namespace, label_selector, rv, known, w):
        """One chunked ``?watch=true`` connection: emit events until the
        server closes it (timeoutSeconds) or an error ends it. Returns
        the resourceVersion to resume from; raises _RelistNeeded on 410.
        """
        query = {
            "watch": "true",
            "allowWatchBookmarks": "true",
            "resourceVersion": rv,
            # Server closes the stream after this long; we then resume
            # from the last seen RV (a cheap request, not a relist).
            "timeoutSeconds": "300",
        }
        if label_selector:
            query["labelSelector"] = label_selector
        url = self._url(gvr, namespace, query=query)
        self._maybe_refresh_exec()
        self._limiter.acquire()
        if w.stopped:
            return rv
        req = urllib.request.Request(url, method="GET")
        req.add_header("Accept", "application/json")
        if self.config.token:
            req.add_header("Authorization", f"Bearer {self.config.token}")
        try:
            resp = urllib.request.urlopen(req, context=self._ssl_ctx, timeout=330)
        except urllib.error.HTTPError as e:
            if e.code == 410:
                raise _RelistNeeded() from e
            raise
        with resp:
            self._set_live_response(w, resp)
            for line in resp:
                if w.stopped:
                    break
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    logger.warning(
                        "watch %s: undecodable event line", gvr.resource
                    )
                    continue
                ev_type = ev.get("type", "")
                obj = ev.get("object") or {}
                if ev_type == "BOOKMARK":
                    rv = (obj.get("metadata") or {}).get("resourceVersion", rv)
                    continue
                if ev_type == "ERROR":
                    if obj.get("code") == 410:
                        raise _RelistNeeded()
                    raise ApiError(
                        f"watch error event: {obj.get('message', obj)}",
                        code=obj.get("code", 500),
                    )
                name = (obj.get("metadata") or {}).get("name", "")
                rv = (obj.get("metadata") or {}).get("resourceVersion", rv)
                if ev_type == "DELETED":
                    known.pop(name, None)
                elif name:
                    known[name] = rv
                w._emit(WatchEvent(ev_type, obj))
        return rv

    @staticmethod
    def _set_live_response(w: Watch, resp) -> None:
        """Point the watch's stop-hook at the live HTTP connection so
        ``stop()`` can sever it out from under a blocked reader.

        Must be a socket ``shutdown()``, not ``resp.close()``: close
        acquires the BufferedReader lock the blocked ``readline`` is
        holding — a deadlock. shutdown() is safe cross-thread and wakes
        the reader with EOF; the reader thread then closes the response
        itself.
        """
        import socket as _socket

        def _sever():
            # resp.fp.raw._sock is CPython's layering; reach it via getattr
            # so other interpreters degrade observably instead of silently
            # leaving the reader blocked until the socket timeout.
            raw = getattr(getattr(resp, "fp", None), "raw", None)
            sock = getattr(raw, "_sock", None)
            if sock is not None:
                try:
                    sock.shutdown(_socket.SHUT_RDWR)
                except Exception:
                    pass
                return
            if raw is not None:
                # SocketIO itself: close() on the raw layer does not take
                # the BufferedReader lock, so it cannot deadlock the way
                # resp.close() would.
                logger.debug(
                    "watch stop: no ._sock on %r; closing raw IO instead",
                    type(raw).__name__,
                )
                try:
                    raw.close()
                except Exception:
                    pass
                return
            logger.debug(
                "watch stop: no severable socket on %r; reader unblocks "
                "at the socket timeout", type(resp).__name__,
            )

        w._on_stop = _sever
        # stop() may have run between connect and hook installation — it
        # would have severed nothing; sever here so the reader never
        # blocks on a connection nobody can cancel.
        if w.stopped:
            _sever()

    # -- poll fallback -----------------------------------------------------

    def _watch_poll(self, gvr, namespace, label_selector) -> Watch:
        w = Watch()

        def _poll():
            known: dict[str, str] = {}  # name -> resourceVersion
            backoff = Backoff(initial=self.poll_interval,
                              cap=max(60.0, self.poll_interval), jitter=True)
            while not w.stopped:
                try:
                    items = self.list(gvr, namespace, label_selector)
                    backoff.reset()
                except Exception as e:  # transient API failures: back off
                    delay = backoff.next_delay()
                    logger.warning(
                        "watch poll %s failed (%s); retrying in %.1fs",
                        gvr.resource, e, delay,
                    )
                    w._stopped.wait(delay)
                    continue  # backoff IS the retry delay; skip the
                    # steady-state poll sleep at the loop bottom
                seen = {}
                for obj in items:
                    name = obj["metadata"]["name"]
                    rv = obj["metadata"].get("resourceVersion", "")
                    seen[name] = rv
                    if name not in known:
                        w._emit(WatchEvent("ADDED", obj))
                    elif known[name] != rv:
                        w._emit(WatchEvent("MODIFIED", obj))
                for name in set(known) - set(seen):
                    w._emit(
                        WatchEvent(
                            "DELETED",
                            {"metadata": {"name": name, "namespace": namespace}},
                        )
                    )
                known.clear()
                known.update(seen)
                w._stopped.wait(self.poll_interval)

        t = threading.Thread(target=_poll, daemon=True, name=f"watch-{gvr.resource}")
        t.start()
        self._watch_threads.append(t)
        self._watches.append(w)
        return w

"""Mutual TLS for the gRPC control plane (port of gorse_tpu/utils/tls.py).

As gorse's common/util/tls.go: both sides load the CA bundle and their own
certificate and key; the server requires the client's certificate
(``CERT_REQUIRED``), so traffic in the cluster is mutually authenticated.
Enabled by ``[master] ssl_mode/ssl_ca/ssl_cert/ssl_key``. Where the reference
builds grpc credentials, ``TLSConfig`` builds ``ssl.SSLContext``s for
protocol/grpcwire.py; both set ALPN to ``h2``, which grpcio requires of its
peer. ``generate_test_certs`` makes a throwaway CA with server and client
certificates through the ``openssl`` command, for tests.
"""

from __future__ import annotations

import dataclasses
import ssl
import subprocess
from pathlib import Path

@dataclasses.dataclass
class TLSConfig:
    """The CA bundle, certificate and key paths (gorse's util.TLSConfig)."""

    ssl_ca: str
    ssl_cert: str
    ssl_key: str

    def server_credentials(self) -> ssl.SSLContext:
        """The server's context: its certificate, the client's required and
        checked against the CA (util.NewServerCreds)."""
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        ctx.load_cert_chain(self.ssl_cert, self.ssl_key)
        ctx.load_verify_locations(self.ssl_ca)
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.set_alpn_protocols(["h2"])
        return ctx

    def channel_credentials(self) -> ssl.SSLContext:
        """The client's context: its certificate presented, the server's
        checked against the CA and the target's host (util.NewClientCreds)."""
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        ctx.load_verify_locations(self.ssl_ca)
        ctx.load_cert_chain(self.ssl_cert, self.ssl_key)
        ctx.set_alpn_protocols(["h2"])
        return ctx


def make_channel(target: str, tls: TLSConfig | None = None):
    """A channel to ``target``, over TLS when a TLSConfig is given."""
    from ..protocol.grpcwire import Channel

    return Channel(target, None if tls is None else tls.channel_credentials())


def bind_port(server, address: str, tls: TLSConfig | None = None) -> int:
    """Bind a server's port, secure when a TLSConfig is given."""
    if tls is None:
        return server.add_insecure_port(address)
    return server.add_secure_port(address, tls.server_credentials())


def generate_test_certs(directory: str | Path, cn: str = "localhost") -> tuple[TLSConfig, TLSConfig]:
    """A throwaway CA with server and client certificates for ``cn`` and
    127.0.0.1, valid two days, through the openssl command; (server_tls,
    client_tls). For tests only."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)

    def run(*args: str) -> None:
        subprocess.run(["openssl", *args], check=True, capture_output=True, cwd=d)

    run("req", "-x509", "-newkey", "rsa:2048", "-nodes", "-days", "2",
        "-keyout", "ca.key", "-out", "ca.pem", "-subj", "/CN=gorse-tpu-test-ca")
    for name in ("server", "client"):
        run("req", "-newkey", "rsa:2048", "-nodes",
            "-keyout", f"{name}.key", "-out", f"{name}.csr", "-subj", f"/CN={cn}")
        # modern TLS stacks check the host against the SAN, not the CN
        ext = d / f"{name}.ext"
        ext.write_text(f"subjectAltName=DNS:{cn},IP:127.0.0.1\n")
        run("x509", "-req", "-in", f"{name}.csr", "-CA", "ca.pem", "-CAkey", "ca.key",
            "-CAcreateserial", "-days", "2", "-out", f"{name}.pem",
            "-extfile", str(ext))
    server = TLSConfig(str(d / "ca.pem"), str(d / "server.pem"), str(d / "server.key"))
    client = TLSConfig(str(d / "ca.pem"), str(d / "client.pem"), str(d / "client.key"))
    return server, client

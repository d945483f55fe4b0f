"""The served ``ingest`` drain ends its HTTP connections before the
``--events`` log closes.

``server.shutdown()`` stops only the accept loop: a keep-alive
connection's handler thread used to live on, answer a request that came
after the drain, and emit into the event log as it closed (which raises
when the emit races the close). Here an unpaced keep-alive client keeps
requesting across the whole drain: no request may be answered after the
command returned, no thread may raise, and no event may follow
``run_end``.
"""

import http.client
import json
import socketserver
import threading
import time

from heatmap_tpu_torch import cli as tcli
from heatmap_tpu_torch import obs


def test_keepalive_client_across_drain(tmp_path, monkeypatch):
    events = tmp_path / "events.jsonl"
    errors = []
    real_handle_error = socketserver.BaseServer.handle_error

    def handle_error(self, request, client_address):
        import sys

        errors.append(sys.exc_info()[1])
        real_handle_error(self, request, client_address)

    monkeypatch.setattr(socketserver.BaseServer, "handle_error", handle_error)
    monkeypatch.setattr(threading, "excepthook",
                        lambda a: errors.append(a.exc_value))
    stop = threading.Event()
    sent = []

    def client(base):
        host, port = base.removeprefix("http://").split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=10)
        while not stop.is_set():
            # Stamp the request when it is sent: a stamp taken after the
            # read can land after ``done`` by a thread switch alone.
            t = time.monotonic()
            try:
                conn.request("GET", "/healthz")
                conn.getresponse().read()
                sent.append(t)
            except (OSError, http.client.HTTPException):
                # The drain closed the connection: open a new one until
                # the listening socket is gone too.
                conn.close()
                conn = http.client.HTTPConnection(host, int(port),
                                                  timeout=10)
        conn.close()

    threads = []

    def on_serve(app, base_url):
        t = threading.Thread(target=client, args=(base_url,), daemon=True)
        t.start()
        threads.append(t)

    args = tcli.build_parser().parse_args([
        "ingest", "--journal", str(tmp_path / "s"),
        "--input", "synthetic:3000:5", "--detail-zoom", "10",
        "--micro-batch", "700", "--serve-port", "0", "--backend", "cpu",
        "--events", str(events)])
    try:
        summary, _ = tcli.run_ingest_command(args, on_serve=on_serve)
        done = time.monotonic()
        # The client goes on requesting after the drain returned.
        threads[0].join(0.5)
    finally:
        stop.set()
        for t in threads:
            t.join(20)
    assert summary["epochs"] == 5 and sent
    # Every answered request was sent before the drain returned; that
    # nothing was answered after it is held by ``run_end`` being last.
    assert max(sent) < done
    assert errors == []
    assert obs.get_event_log() is None
    lines = [json.loads(x) for x in events.read_text().splitlines()]
    assert lines[-1]["event"] == "run_end"
    assert any(x["event"] == "http_request" for x in lines)

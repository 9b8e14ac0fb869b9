"""Tenant and SLO-class headers on ``POST /v1/generate``: the port's stdlib
REST app (``seldon_core_tpu_torch/transport/rest.py``) against the JAX
package's aiohttp app, on the CPU, with the header cases of
``tests/test_scheduler.py::test_rest_headers_thread_into_scheduler``.

- both apps answer 400 for an unknown class, in a header or in the body, on
  the batcher branch, the ``"prompts"`` branch and the per-request
  temperature branch;
- a tenant or the ``batch`` class (header or body) is served: the port's app
  answers the JAX app's status and tokens on the same weights;
- the port answers 200 for ``interactive`` (or its alias ``latency``), or no
  class, with the tokens of its private ``generate()``."""

import asyncio
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu.transport.rest import make_component_app as jax_app
from seldon_core_tpu_torch.servers.llmserver import LLMServer
from seldon_core_tpu_torch.transport.rest import make_component_app, start

KW = dict(vocab_size=256, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
          max_seq_len=64, dtype="float32")
COMMON = dict(model="transformer", model_kwargs=KW, init_random=True, max_new_tokens=3,
              len_buckets=(16,), batch_buckets=(1, 4), temperature=0.0, eos_id=-1, seed=3,
              continuous_batching=2)

GOLD = {"Seldon-SLO-Class": "gold"}
# (body, headers): an unknown class on every branch, by header and by body
UNKNOWN_CLASS = [
    ({"prompt": [5, 9, 2], "max_new_tokens": 2}, GOLD),
    ({"prompts": [[5, 9, 2]], "max_new_tokens": 2}, GOLD),
    ({"prompt": [5], "max_new_tokens": 2, "temperature": 0.7}, GOLD),
    ({"prompt": [5], "max_new_tokens": 2, "slo_class": "gold"}, {}),
    ({"prompts": [[5]], "max_new_tokens": 2, "slo_class": "gold"}, {}),
    ({"prompt": [5], "max_new_tokens": 2, "temperature": 0.7, "slo_class": "gold"}, {}),
    # the body wins over the header, and the check comes before any 501
    ({"prompt": [5], "max_new_tokens": 2, "slo_class": "gold"},
     {"Seldon-SLO-Class": "interactive"}),
    ({"prompt": [5], "max_new_tokens": 2, "stream": True}, GOLD),
]
BRANCHES = ["batcher", "prompts", "temperature", "body batcher", "body prompts",
            "body temperature", "body over header", "before 501"]


@pytest.fixture(scope="module")
def port_url():
    server = LLMServer(device="cpu", **COMMON)
    server.load()
    httpd, _ = start(make_component_app(server, device="cpu"))
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", server
    finally:
        httpd.shutdown()
        httpd.server_close()
        if getattr(server, "_batcher_service", None) is not None:
            server._batcher_service.close()


def _post(url, body, headers):
    req = urllib.request.Request(url + "/v1/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **headers})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("case", range(len(UNKNOWN_CLASS)), ids=BRANCHES)
def test_port_unknown_class_is_400_on_every_branch(port_url, case):
    body, headers = UNKNOWN_CLASS[case]
    code, payload = _post(port_url[0], body, headers)
    assert code == 400, payload
    assert "unknown SLO class" in payload["status"]["info"]


def test_jax_app_unknown_class_is_400_on_every_branch():
    from aiohttp.test_utils import TestClient, TestServer

    server = JaxLLMServer(**COMMON, tenant_quota=0)
    server.load()

    async def go():
        codes = []
        async with TestClient(TestServer(jax_app(server))) as client:
            for body, headers in UNKNOWN_CLASS:
                resp = await client.post("/v1/generate", json=body, headers=headers)
                codes.append(resp.status)
        return codes

    assert asyncio.run(go()) == [400] * len(UNKNOWN_CLASS)


SERVED = [
    ({"prompt": [5, 9, 2]}, {"Seldon-Tenant": "acme", "Seldon-SLO-Class": "batch"}),
    ({"prompt": [5, 9, 2]}, {"Seldon-Tenant": "acme"}),
    ({"prompt": [5, 9, 2], "tenant": "acme"}, {}),
    ({"prompt": [5, 9, 2]}, {"Seldon-SLO-Class": "batch"}),
    ({"prompt": [5, 9, 2], "slo_class": "bulk"}, {}),
    ({"prompts": [[5, 9, 2]], "slo_class": "batch"}, {}),
    ({"prompt": [5, 9, 2], "slo_class": "batch"}, {"Seldon-SLO-Class": "interactive"}),
]


@pytest.fixture(scope="module")
def same_weights():
    """(port URL, the JAX app's (status, body) for each SERVED case): the
    JAX server and a port server on its weights, both batching."""
    from aiohttp.test_utils import TestClient, TestServer

    j = JaxLLMServer(**COMMON)
    j.load()

    async def go():
        out = []
        async with TestClient(TestServer(jax_app(j))) as client:
            for body, headers in SERVED:
                resp = await client.post("/v1/generate", json=body, headers=headers)
                out.append((resp.status, await resp.json()))
        j._batcher_service.close()
        return out

    want = asyncio.run(go())
    server = LLMServer(device="cpu", **{k: v for k, v in COMMON.items() if k != "init_random"})
    server.load(params={"params": jax.tree_util.tree_map(np.asarray, j._params["params"])})
    httpd, _ = start(make_component_app(server, device="cpu"))
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", want
    finally:
        httpd.shutdown()
        httpd.server_close()
        if getattr(server, "_batcher_service", None) is not None:
            server._batcher_service.close()


@pytest.mark.parametrize("case", range(len(SERVED)),
                         ids=["tenant+batch header", "tenant header", "tenant body",
                              "batch header", "bulk body", "batch body prompts",
                              "batch body over header"])
def test_port_tenant_or_batch_class_is_served(same_weights, case):
    url, want = same_weights
    body, headers = SERVED[case]
    code, payload = _post(url, body, headers)
    assert (code, payload) == want[case]
    assert code == 200 and payload["tokens"]


@pytest.mark.parametrize("body,headers", [
    ({"prompt": [5, 9, 2]}, {}),
    ({"prompt": [5, 9, 2]}, {"Seldon-SLO-Class": "interactive"}),
    ({"prompt": [5, 9, 2]}, {"seldon-slo-class": "Latency"}),
    ({"prompt": [5, 9, 2], "slo_class": "interactive"}, {}),
    ({"prompt": [5, 9, 2], "slo_class": "interactive"}, {"Seldon-SLO-Class": "batch"}),
], ids=["no class", "interactive header", "latency header", "interactive body",
        "interactive body over header"])
def test_port_default_class_is_served(port_url, body, headers):
    url, server = port_url
    code, payload = _post(url, body, headers)
    assert code == 200, payload
    assert payload["tokens"] == server.generate([[5, 9, 2]])["tokens"][0]

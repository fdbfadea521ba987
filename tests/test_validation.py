"""The stdlib request validator (`api/validation.py`) on the request
schemas: coercion, bounds, nesting, model validators, and the 422 body."""

import json
import urllib.error
import urllib.request

import pytest

from mcos_tpu.api import schemas
from mcos_tpu.api.validation import (BaseModel, Field, ValidationError,
                                     model_validator)


class Leaf(BaseModel):
    x: float = Field(1.0, gt=0.0, le=10.0)
    tag: str = Field("a", pattern="^(a|b)$")


class Tree(BaseModel):
    n: int
    leaf: Leaf = Leaf()
    leaves: list[Leaf] = Field(default_factory=list, max_length=2)
    maybe: list[float] | None = None
    extra: dict = Field(default_factory=dict)

    @model_validator(mode="after")
    def _n_small(self):
        if self.n > 100:
            raise ValueError("n must be at most 100")
        return self


def test_defaults_coercion_and_nesting():
    t = Tree(n=3.0, leaf={"x": 2}, leaves=[{"x": "0.5"}],
             maybe=[1, 2.5], unknown="ignored")
    assert t.n == 3 and isinstance(t.n, int)
    assert t.leaf.x == 2.0 and isinstance(t.leaf.x, float)
    assert t.leaves[0].x == 0.5
    assert t.maybe == [1.0, 2.5]
    assert t.model_dump() == {"n": 3, "leaf": {"x": 2.0, "tag": "a"},
                              "leaves": [{"x": 0.5, "tag": "a"}],
                              "maybe": [1.0, 2.5], "extra": {}}
    # Mutable defaults are not shared between instances.
    a, b = Tree(n=1), Tree(n=1)
    a.extra["k"] = 1
    assert b.extra == {} and a.leaf is not b.leaf


@pytest.mark.parametrize("body,loc", [
    ({}, "n"),                                  # required
    ({"n": 1.5}, "n"),                          # not integral
    ({"n": 1, "leaf": {"x": 0.0}}, "leaf.x"),   # gt
    ({"n": 1, "leaf": {"x": 11}}, "leaf.x"),    # le
    ({"n": 1, "leaf": {"tag": "c"}}, "leaf.tag"),   # pattern
    ({"n": 1, "leaves": [{}, {}, {}]}, "leaves"),    # max_length
    ({"n": 1, "maybe": ["x"]}, "maybe.0"),      # list item type
    ({"n": 1, "extra": [1]}, "extra"),          # dict
    ({"n": None}, "n"),                         # None for a required field
])
def test_field_errors_name_their_location(body, loc):
    with pytest.raises(ValidationError) as ei:
        Tree(**body)
    assert loc in [e[0] for e in ei.value.errors]
    assert loc in str(ei.value)


def test_model_validator_runs_after_fields():
    with pytest.raises(ValidationError, match="n must be at most 100"):
        Tree(n=101)
    assert isinstance(ValidationError("M", []), ValueError)


def test_request_schemas_validate_like_before():
    req = schemas.PriceRequest(spot=22500, strike=22500, T=0.25,
                               params={"kappa": 2})
    assert req.num_paths == 500_000 and req.use_sobol is True
    assert req.params.to_params().kappa == 2.0
    with pytest.raises(ValidationError):
        schemas.PriceRequest(spot=22500, strike=22500, T=0.25,
                             num_paths=10_000_000)
    with pytest.raises(ValidationError):
        schemas.SVCJParamsRequest(mu_v=0.5, rho_j=3.0)   # rho_j*mu_v >= 1


def test_422_body_carries_the_validation_message():
    from mcos_tpu.api.server import serve
    import threading

    httpd = serve("127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/api/price",
            data=json.dumps({"spot": 22500.0, "strike": 22500.0}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 422
        detail = json.loads(ei.value.read())["detail"]
        assert "PriceRequest" in detail and "T" in detail
        assert "Field required" in detail
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)

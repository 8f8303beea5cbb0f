"""``repro_torch/sharded_step_time.py`` on the CPU: 4 gloo ranks time the
sharded step's EF21-P cases (the smoke gemma-2b under data parallelism and
act_spec on (4, 1) / (2, 2)), and the bytes a step are the step's own:
the shift's fp32 slices gathered beside x^{t+1}'s."""
import json

from repro_torch import configs
from repro_torch import sharded_step_time as ST
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.models import params as P
from repro_torch.train import sharded as SH


def test_ef21p_cases_on_the_cpu(tmp_path):
    names = ["ef21p/gemma-2b/data", "ef21p/gemma-2b/act"]
    out = tmp_path / "st.json"
    res = ST.main(["--device", "cpu", "--steps", "1", "--cases", *names, "--out", str(out)])
    assert res == json.loads(out.read_text()) and sorted(res) == sorted(names)
    d = sum(P.leaf_sizes(lm.lm_spec(configs.get_smoke("gemma-2b"))))
    for name in names:
        r = res[name]
        shape = ST.CASES[name][7]
        lay = SH.Layout(Mesh(("data", "model"), shape), 0, 4, d, act=ST.CASES[name][8] == "act")
        assert len(r["ms"]) == 1 and r["median_ms"] > 0 and r["peak_gib"] is None
        assert r["moved"]["all-gather"] == (4 + 4) * lay.padded  # x^(t+1) and the fp32 shift, over every rank
        assert r["moved"]["reduce-scatter"] == 4 * lay.shard_len and r["moved"]["all-reduce"] == 4 * (4 + 1)

"""lm-evaluation-harness adapter for the Mamba LM.

Port of the JAX package's ``cli/lm_eval_harness.py`` (the reference's
evals/lm_harness_eval.py:14-30).  The request semantics (``loglikelihood``,
``loglikelihood_rolling``, ``generate_until``) live in ``MambaEvalCore``,
which needs no ``lm_eval`` and is tested directly; ``build_wrapper`` puts it
behind ``lm_eval.api.model.LM`` when the harness is installed.

  python -m vivim_tpu_torch.cli.lm_eval_harness --tasks lambada_openai \\
      --hf_dir /path/to/mamba-130m --tokenizer EleutherAI/gpt-neox-20b

Runs on the card unless given ``--device cpu``.  ``--tp_shards N`` /
``--pp_stages N`` score tensor- / pipeline-parallel over N ranks, one
process each under ``torchrun --nproc_per_node N`` (``--dist_backend gloo
--device cuda:0`` shares one card).
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from vivim_tpu_torch.utils.profiling import span


def _check_sharding(tp_shards, pp_stages):
    if tp_shards > 1 and pp_stages > 1:
        raise ValueError(
            "tp_shards and pp_stages are mutually exclusive — pick "
            "one sharding for the eval forward")


class MambaEvalCore:
    """lm_eval request semantics over the LM's forward and
    ``nn.lm.generate``.

    ``tokenizer`` needs ``encode(str) -> list[int]`` and ``decode(list[int])
    -> str``.  ``params`` is a flat parameter dict (``nn.lm.lm_params``, a
    bf16 copy, or an int8 dict of ``nn.quant.quantize_lm_params``): float
    dicts score through the model's own forward (``torch.func.
    functional_call``), int8 ones through ``nn.lm.forward_functional``, the
    path decode serves.

    ``tp_shards > 1`` runs everything tensor-parallel over a 1-D ``model``
    mesh of that many ranks (the run's process group): scoring through
    ``parallel.tensor_parallel.lm_tp_forward``, greedy continuations
    through ``tp_generate``.  ``pp_stages > 1`` scores pipeline-parallel
    over a ``pipe`` mesh (``parallel.pipeline.lm_pp_forward``, ``n_micro=1``:
    a scoring batch is one sequence, so the pipeline buys the k-way split of
    the layers, not microbatch overlap); continuations run on one device's
    token loop, so a stage's rank holds the whole model.  A TP rank's core
    holds its own split.  The two are mutually exclusive (a ``ValueError``).
    """

    def __init__(self, model, params, tokenizer, max_gen_toks=128,
                 eot_token_id=None, tp_shards=1, pp_stages=1):
        from vivim_tpu_torch.nn.lm import forward_functional
        from vivim_tpu_torch.nn.quant import tree_has_qtensor
        from vivim_tpu_torch.parallel.mesh import make_mesh

        _check_sharding(tp_shards, pp_stages)
        self.model = model
        self.params = params
        self.tokenizer = tokenizer
        self.max_gen_toks = max_gen_toks
        self.eot_token_id = (
            eot_token_id if eot_token_id is not None
            else getattr(tokenizer, "eos_token_id", None) or 0)
        self.device = next(model.parameters()).device
        self._tp_mesh = None
        impl = model.scan_implementation
        if pp_stages > 1:
            from vivim_tpu_torch.parallel.pipeline import lm_pp_forward

            mesh = make_mesh(pp_stages, axis="pipe")
            self._fwd = lambda toks: lm_pp_forward(
                model.cfg, params, toks, mesh, n_micro=1,
                implementation=impl)
        elif tp_shards > 1:
            from vivim_tpu_torch.parallel.tensor_parallel import (
                lm_tp_forward,
                split_tp_params,
            )

            self._tp_mesh = make_mesh(tp_shards, axis="model")
            # this rank's split, tensors of its own: the caller may free
            # the whole weights (the CLI does)
            self.params = {k: v.clone() for k, v in
                           split_tp_params(params, self._tp_mesh).items()}
            self._fwd = lambda toks: lm_tp_forward(
                model.cfg, self.params, toks, self._tp_mesh,
                implementation=impl)
        elif tree_has_qtensor(params):
            self._fwd = lambda toks: forward_functional(model, params, toks)
        else:
            self._fwd = lambda toks: torch.func.functional_call(
                model, params, (toks,))

    def _tokens(self, ids):
        return torch.tensor([list(ids)], dtype=torch.long,
                            device=self.device)

    @torch.no_grad()
    def _score(self, ctx_ids, cont_ids):
        """Sum of log p(cont | ctx), and whether cont is the greedy
        argmax.  Spans: ``lm.score`` holds the scoring forward's
        ``lm.forward`` (the head included)."""
        with span("lm.score"):
            tokens = self._tokens(list(ctx_ids) + list(cont_ids))
            with span("lm.forward"):
                logits = self._fwd(tokens)[0]
            logp = torch.log_softmax(logits.float(), -1)
            start = len(ctx_ids) - 1
            positions = logp[start:start + len(cont_ids)]
            cont = torch.tensor(list(cont_ids), device=logp.device)
            ll = float(positions.gather(-1, cont[:, None]).sum())
            greedy = bool((positions.argmax(-1) == cont).all())
        return ll, greedy

    def loglikelihood_pair(self, ctx: str, cont: str):
        ctx_ids = self.tokenizer.encode(ctx) if ctx else [self.eot_token_id]
        return self._score(ctx_ids, self.tokenizer.encode(cont))

    def loglikelihood_rolling_str(self, text: str):
        """Every token predicted from its prefix, the EOT token the
        context of the first (the lm_eval rolling convention)."""
        ll, _ = self._score([self.eot_token_id], self.tokenizer.encode(text))
        return ll

    def generate_until_str(self, ctx: str, until=(), max_gen_toks=None):
        """Greedy continuation, cut at eos and at the first stop string."""
        from vivim_tpu_torch.nn import lm as lm_lib

        ctx_ids = self.tokenizer.encode(ctx) if ctx else [self.eot_token_id]
        kw = dict(
            generator=torch.Generator(device=self.device).manual_seed(0),
            temperature=0.0, eos_token_id=self.eot_token_id)
        n_new = max_gen_toks or self.max_gen_toks
        if self._tp_mesh is not None:
            from vivim_tpu_torch.parallel.tensor_parallel import tp_generate

            out = tp_generate(
                self.model, self.params, self._tokens(ctx_ids), n_new,
                self._tp_mesh, implementation=self.model.scan_implementation,
                **kw)
        else:
            out = lm_lib.generate(self.model, self.params,
                                  self._tokens(ctx_ids), n_new, **kw)
        new_ids = out[0, len(ctx_ids):].tolist()
        if self.eot_token_id in new_ids:
            new_ids = new_ids[:new_ids.index(self.eot_token_id)]
        text = self.tokenizer.decode(new_ids)
        for stop in until or ():
            if stop and stop in text:
                text = text[:text.index(stop)]
        return text


def build_wrapper(model, params, tokenizer, **core_kw):
    """``MambaEvalCore`` behind lm_eval's ``LM`` interface (needs
    lm-evaluation-harness; evals/lm_harness_eval.py:14-30)."""
    try:
        from lm_eval.api.model import LM
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "lm_eval is not installed in this environment; install "
            "lm-evaluation-harness to run LM evals") from e

    core = MambaEvalCore(model, params, tokenizer, **core_kw)

    class MambaEvalWrapper(LM):  # pragma: no cover - needs lm_eval
        def loglikelihood(self, requests):
            return [core.loglikelihood_pair(*req.args) for req in requests]

        def loglikelihood_rolling(self, requests):
            return [core.loglikelihood_rolling_str(req.args[0])
                    for req in requests]

        def generate_until(self, requests):
            out = []
            for req in requests:
                ctx, gen_kwargs = req.args
                out.append(core.generate_until_str(
                    ctx, until=gen_kwargs.get("until", ()),
                    max_gen_toks=gen_kwargs.get("max_gen_toks")))
            return out

    return MambaEvalWrapper()


def resolve_hf_repo(repo_id: str) -> str:
    """Download (or reuse the local cache of) a mamba LM snapshot from the
    HF hub and return its directory (utils/hf.py:9-23).  Offline this
    raises, naming ``--hf_dir`` (a fetched snapshot) as the route."""
    try:
        from huggingface_hub import snapshot_download

        return snapshot_download(
            repo_id, allow_patterns=["config.json", "pytorch_model.bin",
                                     "*.safetensors"])
    except Exception as e:
        raise SystemExit(
            f"could not download {repo_id!r} from the HF hub ({e}); in an "
            "offline environment pass --hf_dir with a local snapshot "
            "(config.json + pytorch_model.bin) instead") from e


def load_lm(ckpt, vocab_size, d_model, n_layer, hf_dir=None, hf_repo=None,
            device="cuda", seed=0):
    """(MambaLM in eval mode on ``device``, its ``lm_params`` dict).

    Weights from a torch state_dict file in the reference layout (``ckpt``),
    from a local HF snapshot directory (``hf_dir``: ``config.json``, whose
    rms_norm / residual_in_fp32 / pad_vocab_size_multiple / ssm_cfg are
    honoured, and ``pytorch_model.bin``), from the hub by repo id
    (``hf_repo``, needs the network), or a random init from ``seed`` when
    all are None.  On the card a config whose d_state the kernels do not
    take (above 256) raises before any weight is read; without a card,
    ``device="cuda"`` raises.
    """
    from vivim_tpu_torch.cli.common import resolve_device
    from vivim_tpu_torch.convert.from_jax import (
        load_torch_state_dict,
        strip_lightning_prefix,
    )
    from vivim_tpu_torch.nn import lm
    from vivim_tpu_torch.nn.layers import init_weights

    if hf_repo and not hf_dir:
        hf_dir = resolve_hf_repo(hf_repo)
    if hf_dir:
        with open(os.path.join(hf_dir, "config.json")) as f:
            cfg = lm.config_from_mamba_json(json.load(f))
        ckpt = ckpt or os.path.join(hf_dir, "pytorch_model.bin")
    else:
        cfg = lm.MambaLMConfig(vocab_size=vocab_size, d_model=d_model,
                               n_layer=n_layer)
    lm.check_kernel_config(cfg, device)
    dev = resolve_device(device)
    model = lm.MambaLM(cfg)
    if ckpt:
        sd = strip_lightning_prefix(load_torch_state_dict(ckpt))
        # the head is tied: a state_dict may carry it or not
        if "backbone.embedding.weight" in sd:
            sd.setdefault("lm_head.weight", sd["backbone.embedding.weight"])
        model.load_state_dict(sd, strict=True)
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(dev).eval()
    return model, lm.lm_params(model)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tasks", type=str, required=True,
                   help="comma-separated lm_eval task names")
    p.add_argument("--ckpt", type=str, default=None,
                   help="torch state-dict checkpoint (HF mamba layout)")
    p.add_argument("--hf_dir", type=str, default=None,
                   help="local HF mamba snapshot dir (config.json + "
                        "pytorch_model.bin); overrides the dim flags")
    p.add_argument("--hf_repo", type=str, default=None,
                   help="HF hub repo id (e.g. state-spaces/mamba-130m); "
                        "downloads the snapshot (needs network)")
    p.add_argument("--tokenizer", type=str,
                   default="EleutherAI/gpt-neox-20b")
    p.add_argument("--vocab", type=int, default=50277)
    p.add_argument("--d_model", type=int, default=768)
    p.add_argument("--n_layer", type=int, default=24)
    p.add_argument("--max_gen_toks", type=int, default=128)
    p.add_argument("--tp_shards", type=int, default=1,
                   help="tensor-parallel shards for scoring (Megatron "
                        "column/row split of every mixer over a 'model' "
                        "mesh axis; ranks under torchrun)")
    p.add_argument("--pp_stages", type=int, default=1,
                   help="pipeline-parallel stages for scoring (GPipe "
                        "stage-split layer stack over a 'pipe' mesh axis; "
                        "ranks under torchrun; mutually exclusive with "
                        "--tp_shards)")
    p.add_argument("--limit", type=int, default=None,
                   help="cap examples per task (smoke runs)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda by default, cuda:LOCAL_RANK "
                        "per rank; cuda:<i> puts every rank on card i, "
                        "gloo only; cpu runs the kernels' plain versions)")
    p.add_argument("--dist_backend", type=str, default="nccl",
                   choices=["nccl", "gloo"],
                   help="torch.distributed backend of the ranks (gloo for "
                        "the CPU, or for ranks that share one card)")
    args = p.parse_args(argv)

    try:
        import lm_eval
    except ImportError:
        raise SystemExit(
            "lm_eval is not installed in this environment. Install "
            "lm-evaluation-harness to run evals; the adapter logic "
            "(MambaEvalCore) works without it and is unit-tested.")

    from transformers import AutoTokenizer

    from vivim_tpu_torch.cli.common import init_model_parallel

    _check_sharding(args.tp_shards, args.pp_stages)
    flag, n, axis = (("--pp_stages", args.pp_stages, "pipe")
                     if args.pp_stages > 1
                     else ("--tp_shards", args.tp_shards, "model"))
    device, mesh = init_model_parallel(n, axis, flag, args.device,
                                       args.dist_backend, "lm_eval_harness")
    tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
    model, params = load_lm(args.ckpt, args.vocab, args.d_model,
                            args.n_layer, hf_dir=args.hf_dir,
                            hf_repo=args.hf_repo, device=device)
    wrapper = build_wrapper(model, params, tokenizer,
                            max_gen_toks=args.max_gen_toks,
                            tp_shards=args.tp_shards,
                            pp_stages=args.pp_stages)
    if args.tp_shards > 1:
        # the core holds this rank's split; the whole weights go (TP reads
        # only the model's config).  Pipeline stages keep the whole model:
        # greedy continuations run the one-device token loop.
        del params
        model.to("meta")
    results = lm_eval.simple_evaluate(
        model=wrapper, tasks=args.tasks.split(","), limit=args.limit)
    if mesh is None or mesh.is_main:
        print(json.dumps(results.get("results", results), indent=2,
                         default=str))
    return results


if __name__ == "__main__":
    main()

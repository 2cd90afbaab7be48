"""Spider: the trainable any-to-many multimodal model (counterpart of
spider_tpu/models/spider.py, training side).

Frozen ImageBind encoder -> 1-token input projection -> (LoRA) Llama with the
extended signal-token vocabulary -> per-modality alignment projectors whose
outputs are trained against the frozen task decoders' text-conditioning
embeddings.

Everything string-shaped happens on the host once per batch
(``prepare_batch``: placeholder splicing, tokenization, signal-span location;
pure numpy and Python, the same code as the reference); everything numeric is
``compute_loss`` on the model's device. ``Spider`` is an ``nn.Module``: where
the JAX class carries a tree of trainable parameters beside the flax modules,
here the submodules own them (``llm``, ``llama_proj``, ``aligners`` or
``moe_aligner``, ``logit_scale``, named as the JAX tree names them), and
``trainable_params()`` lists those an optimizer may move. The frozen encoder
runs under ``torch.no_grad()``.

Inference is ``generate``: one request's prompt through the same host
preparation, a greedy decode that keeps each step's hidden states
(``decode.generate``), the tag parse of the answer, and for each tag span the
decoder it names (``_decode_modality_infer``): the signal tokens' hidden
states through the aligner, fused 0.1 / 0.9 with the decoder's own text
conditioning. BOX goes to a ``box_decoder`` callable; MASK to SAM
(``_decode_mask_infer``: the box decoder's top box, rescaled to the SAM
input, prompts ``Sam.predict_box``).

MASK training: with ``sam`` and a batch holding ``IMAGE_SAM`` and ``MASK``,
the projected [MASK0] state prompts SAM's mask decoder as a text embedding
(``predict_text``), and the masks, resized to the ground truth's size, are
held to it by 2 * BCE + 0.5 * dice. Only the mask decoder trains: Spider
freezes SAM's image and prompt encoders (no gradient, out of the
optimizer). Without SAM, MASK trains the text loss and decodes to nothing,
as in the reference.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spider_tpu_torch.common.registry import registry
from spider_tpu_torch.models import tags
from spider_tpu_torch.models.decode import GenerateConfig, generate
from spider_tpu_torch.models.llama import LlamaForCausalLM, cross_entropy_loss
from spider_tpu_torch.models.tokenizer import DEFAULT_MODALITY_TOKENS

IGNORE = -100


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def l2_loss(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Summed squared error per sample, then mean."""
    d = (u.float() - v.float()) ** 2
    return d.reshape(d.shape[0], -1).sum(dim=1).mean()


def clip_align_loss(text_embeds: torch.Tensor, image_embeds: torch.Tensor,
                    logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over flattened token embeddings."""
    t = text_embeds.float().reshape(-1, text_embeds.shape[-1])
    i = image_embeds.float().reshape(-1, image_embeds.shape[-1])
    t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-8)
    i = i / (torch.linalg.vector_norm(i, dim=-1, keepdim=True) + 1e-8)
    logits = t @ i.T * torch.exp(logit_scale)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2.0


def sigmoid_bce_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p, t = pred.float(), target.float()
    per_pixel = p.clamp_min(0) - p * t + torch.log1p(torch.exp(-p.abs()))
    return per_pixel.reshape(per_pixel.shape[0], -1).mean(-1).sum()


def dice_loss(pred: torch.Tensor, target: torch.Tensor, scale: float = 1000.0,
              eps: float = 1e-6) -> torch.Tensor:
    p = torch.sigmoid(pred.float()).reshape(pred.shape[0], -1)
    t = target.float().reshape(target.shape[0], -1)
    num = 2 * (p / scale * t / scale).sum(-1)
    den = ((p / scale) ** 2).sum(-1) + ((t / scale) ** 2).sum(-1)
    return (1 - (num + eps) / (den + eps)).sum()


# ---------------------------------------------------------------------------
# Host-side batch preparation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PreparedBatch:
    """Numeric view of one training batch (numpy, on the host)."""
    input_ids: np.ndarray          # [B, L] (modality slots hold pad_id)
    slot_mask: Dict[str, np.ndarray]   # modality -> [B, L] one-hot rows
    slot_index: Dict[str, np.ndarray]  # modality -> [B, L] index into inputs
    targets: np.ndarray            # [B, L] with IGNORE outside answer
    # per-modality encoder inputs, stacked over occurrences (host order)
    modality_inputs: Dict[str, np.ndarray]
    # signal-token span positions per sample (for hidden-state taps):
    signal_pos: Optional[np.ndarray] = None   # [B, n_signal]
    text_span: Optional[np.ndarray] = None    # [B, 2] (start, end) caption span


def split_placeholder(text: str) -> List[str]:
    """'<IMAGE><IMAGE-Placeholder></IMAGE> a dog' ->
    ['<IMAGE>', '<IMAGE-Placeholder>', '</IMAGE> a dog']."""
    pattern = r"<[A-Z]+-Placeholder>"
    out, start = [], 0
    for m in re.finditer(pattern, text):
        out.append(text[start:m.start()])
        out.append(m.group())
        start = m.end()
    out.append(text[start:])
    return out


def get_modality(split: str) -> str:
    m = re.search(r"<([A-Z]+)-Placeholder>", split)
    if not m:
        raise ValueError(f"no placeholder in {split!r}")
    return m.group(1)


def get_llm_text_res_train(string: str, modality: str) -> List[str]:
    """Caption between <X> and [X0] (training answer grammar)."""
    return re.findall(rf"<{modality}>(.*?)\[{modality}0\]", string)


@registry.register_model("spider")
class Spider(nn.Module):
    """The trainable model with its host-side orchestration.

    Components (all optional except llm and tokenizer; an absent one turns
    its branch off):
      llm: LlamaForCausalLM            tokenizer: extended tokenizer
      encoder: ImageBindEncoder (frozen here) or None
      llama_proj: nn.Linear(encoder embed_dim -> llm hidden) or None
      aligners: {modality: TextFcLayer} or moe_aligner: TextFcLayerMoE
      diffusion_pipes: {IMAGE/VIDEO/AUDIO: pipeline}, the frozen decoders
        whose text conditioning is the alignment target (not submodules)
      box_decoder: callable (image, caption) -> {bboxes, label_names,
        scores}, or None (Grounding DINO inference)
      sam: models/sam.py's Sam, or None; its image and prompt encoders are
        frozen here, its mask decoder trains
    """

    @classmethod
    def from_config(cls, model_config: Dict[str, Any], *, device) -> "Spider":
        from spider_tpu_torch.models.factory import build_spider_from_config

        return build_spider_from_config(dict(model_config), device=device)

    def __init__(self, *, llm: LlamaForCausalLM, tokenizer, name: str = "spider",
                 encoder: Optional[nn.Module] = None,
                 llama_proj: Optional[nn.Linear] = None,
                 aligners: Optional[Dict[str, nn.Module]] = None,
                 moe_aligner: Optional[nn.Module] = None,
                 diffusion_pipes: Optional[Dict[str, Any]] = None,
                 sam=None, box_decoder=None,
                 modality_tokens: Optional[Dict[str, int]] = None,
                 max_context_len: int = 100,
                 use_embed_align_loss: bool = False,
                 only_embed_align_loss: bool = False,
                 word_align_loss: bool = False,
                 only_llm_gen_loss: bool = False,
                 alignment_layer: Sequence[int] = (-1,),
                 logit_scale: float = 1.0):
        super().__init__()
        self.model_name = name
        self.llm = llm
        self.tokenizer = tokenizer
        self.encoder = encoder
        if encoder is not None:
            encoder.requires_grad_(False).eval()
        self.llama_proj = llama_proj
        self.aligners = nn.ModuleDict(aligners or {})
        self.moe_aligner = moe_aligner
        self.diffusion_pipes = dict(diffusion_pipes or {})
        self.sam = sam
        if sam is not None:
            sam.image_encoder.requires_grad_(False).eval()
            sam.prompt_encoder.requires_grad_(False)
        self.box_decoder = box_decoder
        self.modality_tokens = dict(modality_tokens or DEFAULT_MODALITY_TOKENS)
        self.max_context_len = max_context_len
        self.use_embed_align_loss = use_embed_align_loss
        self.only_embed_align_loss = only_embed_align_loss
        self.word_align_loss = word_align_loss
        self.only_llm_gen_loss = only_llm_gen_loss
        self.alignment_layer = tuple(alignment_layer)
        self.logit_scale = nn.Parameter(torch.tensor(float(logit_scale), dtype=torch.float32,
                                                     device=llm.device))

        self._tok_cache: Dict[str, List[int]] = {}
        self._signal_ids = {
            m: [self._one_id(f"[{m}{i}]") for i in range(n)]
            for m, n in self.modality_tokens.items()
        }
        self._end_id = self._one_id("[END]")

    @property
    def device(self) -> torch.device:
        return self.llm.device

    # ------------------------------------------------------------- tokenizer
    def _ids(self, text: str) -> List[int]:
        if text not in self._tok_cache:
            self._tok_cache[text] = list(
                self.tokenizer(text, add_special_tokens=False).input_ids)
        return list(self._tok_cache[text])

    def _one_id(self, token: str) -> int:
        ids = self._ids(token)
        if len(ids) != 1:
            raise ValueError(f"{token} is not one token of the tokenizer: {ids}")
        return ids[0]

    # ------------------------------------------------ trainable param bundle
    def trainable_params(self) -> Dict[str, nn.Parameter]:
        """{dotted name: parameter} of everything an optimizer may move:
        every parameter that requires grad outside the frozen encoder (and
        SAM's frozen image and prompt encoders, which require none)."""
        return {n: p for n, p in self.named_parameters()
                if p.requires_grad and not n.startswith("encoder.")}

    def train(self, mode: bool = True):
        super().train(mode)
        if self.encoder is not None:
            self.encoder.eval()
        if self.sam is not None:
            self.sam.image_encoder.eval()
        return self

    # -------------------------------------------------------------- prepare
    def prepare_batch(self, samples: Dict[str, Any]) -> PreparedBatch:
        """Host: placeholder splicing + tokenization + signal-span location.

        sequence = [BOS] [INPUT] question(+modality slots) taskprompt
        (systemprompt) [OUTPUT] answer-with-signal-tokens [END], targets
        IGNORE outside the answer span.
        """
        tok = self.tokenizer
        pad_id = tok.pad_token_id
        bos_id = tok.bos_token_id
        B = len(samples["Question"])

        all_ids: List[List[int]] = []
        slot_entries: List[List[Tuple[int, str, int]]] = []  # (pos, modality, occurrence)
        target_spans: List[Tuple[int, List[int]]] = []
        modality_counts: Dict[str, int] = {}

        for idx in range(B):
            question = samples["Question"][idx]
            ids: List[int] = [bos_id] + self._ids("[INPUT]")
            slots: List[Tuple[int, str, int]] = []
            for split in split_placeholder(question):
                if "Placeholder" in split:
                    modality = get_modality(split)
                    occ = modality_counts.get(modality, 0)
                    modality_counts[modality] = occ + 1
                    slots.append((len(ids), modality, occ))
                    ids.append(pad_id)  # placeholder slot: 1 token
                elif split:
                    ids.extend(self._ids(split))
            ids.extend(self._ids(samples["TaskPrompt"][idx]))
            if "SystemPrompt" in samples:
                ids.extend(self._ids(samples["SystemPrompt"][idx]))
            # truncate the question part
            slots = [s for s in slots if s[0] < self.max_context_len]
            ids = ids[: self.max_context_len]

            # answer: replace placeholders with the signal-token run
            rebuilt = []
            for part in split_placeholder(samples["Answer"][idx]):
                if "Placeholder" in part:
                    m = get_modality(part)
                    rebuilt.append("".join(
                        f"[{m}{i}]" for i in range(self.modality_tokens[m])))
                else:
                    rebuilt.append(part)
            answer_text = "[OUTPUT]" + "".join(rebuilt) + "[END]"
            answer_ids = self._ids(answer_text)[: self.max_context_len]

            q_len = len(ids)
            ids = ids + answer_ids
            target_spans.append((q_len, answer_ids))
            all_ids.append(ids)
            slot_entries.append(slots)

        L = max(len(i) for i in all_ids)
        input_ids = np.full((B, L), pad_id, np.int64)
        targets = np.full((B, L), IGNORE, np.int64)
        for i, ids in enumerate(all_ids):
            input_ids[i, : len(ids)] = ids
            q_len, answer_ids = target_spans[i]
            targets[i, q_len: q_len + len(answer_ids)] = answer_ids

        # signal-token + caption-text spans for the alignment taps: within
        # the answer, <X> ... [X0..Xn] </X>; caption tokens are those between
        # <X> and [X0].
        task = samples["TaskPrompt"][0][1:-1] if samples.get("TaskPrompt") else ""
        if task in self.modality_tokens:
            n_sig = self.modality_tokens[task]
            begin_id = self._one_id(f"<{task}>")
            sig0 = self._signal_ids[task][0]
            pos = np.zeros((B, n_sig), np.int64)
            spans = np.zeros((B, 2), np.int64)
            for i in range(B):
                row = targets[i]
                begins = np.where(row == begin_id)[0]
                s0 = np.where(row == sig0)[0]
                if len(begins) and len(s0):
                    start = int(s0[0])
                    pos[i] = np.arange(start, start + n_sig)
                    spans[i] = (int(begins[0]) + 1, start)
            signal_pos, text_span = pos, spans
        else:
            signal_pos, text_span = None, None

        # gather per-modality encoder inputs in occurrence order
        modality_inputs: Dict[str, np.ndarray] = {}
        slot_mask = {m: np.zeros((B, L), bool) for m in modality_counts}
        slot_index = {m: np.zeros((B, L), np.int64) for m in modality_counts}
        for m, count in modality_counts.items():
            stacked = []
            for i in range(B):
                v = samples[m][i]
                if isinstance(v, list):
                    stacked.extend(np.asarray(x) for x in v)
                else:
                    stacked.append(np.asarray(v))
            modality_inputs[m] = np.stack(stacked[:count], axis=0) \
                if stacked else np.zeros((0,))
        for i, slots in enumerate(slot_entries):
            for pos_, m, occ in slots:
                slot_mask[m][i, pos_] = True
                slot_index[m][i, pos_] = occ

        return PreparedBatch(
            input_ids=input_ids, slot_mask=slot_mask, slot_index=slot_index,
            targets=targets, modality_inputs=modality_inputs,
            signal_pos=signal_pos, text_span=text_span)

    # --------------------------------------------------------------- embeds
    def _tensor(self, arr, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=dtype).to(self.device)

    def _frozen_target(self, cond) -> torch.Tensor:
        """A decoder's text conditioning (tensor or numpy) as an fp32 constant
        on the model's device. Copied: the pipelines encode under
        ``torch.inference_mode()``, and autograd saves no inference tensor."""
        return torch.as_tensor(cond).detach().to(self.device, torch.float32, copy=True)

    def _splice_embeds(self, batch: PreparedBatch,
                       modality_embeds: Dict[str, torch.Tensor]) -> torch.Tensor:
        """input_ids -> embeddings with modality slots overwritten by the
        projected encoder outputs (1 token per occurrence)."""
        embeds = self.llm.embed(self._tensor(batch.input_ids))
        if self.llama_proj is None:
            return embeds
        for m, enc in modality_embeds.items():
            if enc.shape[0] == 0:
                continue
            proj = self.llama_proj(enc.to(self.llama_proj.weight.dtype))
            mask = self._tensor(batch.slot_mask[m])[..., None]
            gathered = proj[self._tensor(batch.slot_index[m])]     # [B, L, H]
            embeds = torch.where(mask, gathered.to(embeds.dtype), embeds)
        return embeds

    def encode_modalities(self, batch: PreparedBatch) -> Dict[str, torch.Tensor]:
        """Frozen ImageBind forward per present modality -> [N_occ, embed_dim]."""
        out: Dict[str, torch.Tensor] = {}
        if self.encoder is None:
            return out
        for m, arr in batch.modality_inputs.items():
            if arr.size == 0:
                continue
            key = "audio" if m == "AUDIO" else "vision"
            with torch.no_grad():
                out[m] = self.encoder({key: self._tensor(arr, torch.float32)})[key]
        return out

    # ----------------------------------------------------------------- loss
    def _apply_aligner(self, modality: str, hidden: torch.Tensor) -> torch.Tensor:
        if self.moe_aligner is not None:
            return self.moe_aligner(hidden, modality=modality)
        return self.aligners[modality](hidden, modality=modality)

    def compute_loss(self, batch: PreparedBatch, modality_embeds: Dict[str, torch.Tensor],
                     cond_embeds: Optional[torch.Tensor], task: str,
                     aux_arrays: Optional[Dict[str, np.ndarray]] = None
                     ) -> Dict[str, torch.Tensor]:
        """cond_embeds: frozen text-conditioning target of the task decoder
        for this batch's captions (None for TEXT/BOX/MASK). aux_arrays, for
        MASK: IMAGE_SAM [B, 3, s, s] and MASK_GT [B, s, s]."""
        embeds = self._splice_embeds(batch, modality_embeds)
        targets = self._tensor(batch.targets)
        logits, hidden_states, _ = self.llm(inputs_embeds=embeds, output_hidden_states=True)
        gen_loss, gen_acc = cross_entropy_loss(logits, targets)
        out = {"gen_loss": gen_loss, "gen_acc": gen_acc}

        no_decoder_loss = (self.only_llm_gen_loss
                           or task not in self.modality_tokens
                           or batch.signal_pos is None
                           or (cond_embeds is None and task != "MASK"))
        if no_decoder_loss:
            out["loss"] = gen_loss
            return out

        # hidden-state taps at signal positions (+ input embeds residual) for
        # each alignment layer, summed.
        H = embeds.shape[-1]
        sig = self._tensor(batch.signal_pos)[..., None].expand(-1, -1, H)   # [B, n_sig, H]
        proj_sum = None
        for layer in self.alignment_layer:
            fused = hidden_states[layer].gather(1, sig) + embeds.gather(1, sig)
            proj = self._apply_aligner(task, fused)
            proj_sum = proj if proj_sum is None else proj_sum + proj

        if task == "MASK":
            return self._mask_loss(out, gen_loss, proj_sum, aux_arrays)

        target = cond_embeds
        if target.ndim == 2:  # AUDIO pooled -> (N, 1, D)
            target = target[:, None, :]
        target = self._frozen_target(target)
        semantic = l2_loss(proj_sum, target) + clip_align_loss(proj_sum, target,
                                                               self.logit_scale)
        out[f"{task}_semantic_align_mse_loss"] = semantic
        out["loss"] = gen_loss + semantic
        return out

    def _mask_loss(self, out: Dict[str, torch.Tensor], gen_loss: torch.Tensor,
                   proj_sum: torch.Tensor, aux_arrays) -> Dict[str, torch.Tensor]:
        """SAM mask-decoder training: the projected [MASK0] state prompts
        the decoder as text embeddings; 2 * BCE + 0.5 * dice against the
        ground truth, each over the batch (spider_tpu/models/spider.py:440-470)."""
        from spider_tpu_torch.models.sam import postprocess_masks

        if self.sam is None or aux_arrays is None:
            raise ValueError("a MASK loss needs sam and the IMAGE_SAM / MASK_GT arrays")
        images = torch.as_tensor(np.asarray(aux_arrays["IMAGE_SAM"]),
                                 dtype=torch.float32).to(self.sam.device)
        masks = self.sam.predict_text(images, proj_sum.float().to(self.sam.device))
        gt = torch.as_tensor(np.asarray(aux_arrays["MASK_GT"])).to(masks.device)
        s = gt.shape[-1]
        pred = postprocess_masks(masks, (s, s), (s, s), img_size=s)[:, 0]
        n = max(gt.shape[0], 1)
        out["bce_loss"] = 2.0 * sigmoid_bce_loss(pred, gt) / n
        out["dice_loss"] = 0.5 * dice_loss(pred, gt) / n
        out["loss"] = gen_loss + out["bce_loss"].to(gen_loss.device) \
            + out["dice_loss"].to(gen_loss.device)
        return out

    def mask_arrays(self, samples: Dict[str, Any]) -> Optional[Dict[str, np.ndarray]]:
        """The MASK branch's IMAGE_SAM and MASK_GT arrays of a batch, or
        None where it trains the text loss only (no SAM, or no IMAGE_SAM)."""
        if self.sam is None or "IMAGE_SAM" not in samples:
            return None
        return {"IMAGE_SAM": np.stack([np.asarray(x) for x in samples["IMAGE_SAM"]]),
                "MASK_GT": np.stack([np.asarray(x) for x in samples["MASK"]])}

    # ---------------------------------------------------------- forward API
    def forward(self, samples: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Training forward: samples dict -> loss dict."""
        task_prompt = samples.get("TaskPrompt", ["[TEXT]"])[0]
        task = task_prompt[1:-1]

        embed_align = None
        if "Caption" in samples and self.use_embed_align_loss:
            embed_align = self.loss_text_encoder_align(samples["Caption"])
            if self.word_align_loss:
                # Local word-level alignment: sample half the caption's words
                # and align each through the same projector. Draws from
                # Python's `random`, as the reference does.
                captions = samples["Caption"]
                words0 = re.findall(r"\b\w+\b", captions[0])
                select = max(1, len(words0) // 2)
                word_total = 0.0
                for _ in range(select):
                    picks = []
                    for cap in captions:
                        words = re.findall(r"\b\w+\b", cap) or [cap]
                        picks.append(random.choice(words))
                    word_total = word_total + self.loss_text_encoder_align(picks)
                embed_align = (embed_align + word_total / float(select)) / 2.0
            if self.only_embed_align_loss:
                return {"loss": embed_align, "gen_loss": embed_align,
                        "gen_acc": torch.zeros((), device=self.device)}

        batch = self.prepare_batch(samples)
        modality_embeds = self.encode_modalities(batch)

        cond_embeds = None
        if task in ("IMAGE", "VIDEO", "AUDIO") and task in self.diffusion_pipes \
                and "Caption" in samples:
            cond_embeds = self.diffusion_pipes[task](prompt=samples["Caption"],
                                                     return_prompts_only=True)
        aux_arrays = self.mask_arrays(samples) if task == "MASK" else None
        if task == "MASK" and aux_arrays is None:
            task = "TEXT"  # no SAM: MASK degrades to gen_loss only

        out = self.compute_loss(batch, modality_embeds, cond_embeds, task, aux_arrays)
        if embed_align is not None:
            out["loss"] = out["loss"] + embed_align
            out[f"{task}_embed_align_mse_loss"] = embed_align
        return out

    def loss_text_encoder_align(self, captions: Sequence[str]) -> torch.Tensor:
        """Align the LLM token-embedding space to the diffusion text encoder
        through the IMAGE aligner."""
        pipe = self.diffusion_pipes.get("IMAGE")
        if pipe is None:
            return torch.zeros((), device=self.device)
        ids = [self._ids(c) for c in captions]
        L = max(len(i) for i in ids)
        arr = np.full((len(ids), L), self.tokenizer.pad_token_id, np.int64)
        for i, r in enumerate(ids):
            arr[i, : len(r)] = r
        proj = self._apply_aligner("IMAGE", self.llm.embed(self._tensor(arr)))
        cond = pipe(prompt=list(captions), return_prompts_only=True)
        cond = self._frozen_target(cond)
        return l2_loss(proj, cond) + clip_align_loss(proj, cond, self.logit_scale)

    # -------------------------------------------------------------- generate
    @torch.inference_mode()
    def generate(self, samples: Dict[str, Any], answers: List[str],
                 predictions: Dict[str, Any], predictions_text: Dict[str, List],
                 max_new_tokens: Optional[int] = None,
                 guidance_scale: float = 7.5, num_inference_steps: int = 40,
                 generator: Optional[torch.Generator] = None):
        """Inference on one sample: decode the answer keeping each step's
        hidden states, parse its '<X>cap[X0..]</X>' spans, fuse the projected
        hidden states 0.1 / 0.9 with each decoder's own text conditioning and
        run the decoder. Appends to answers, predictions and predictions_text
        and returns the three. `generator` is the decode's only source of
        randomness (None: seeded with 0)."""
        # The tag parse and the dispatch below read sample 0's answer and
        # hidden states; a batch would silently return only sample 0's media.
        if len(samples["Question"]) != 1:
            raise ValueError(
                f"Spider.generate is single-sample (got batch "
                f"{len(samples['Question'])}); loop over samples or use "
                "serving/continuous.py for batched text decode")
        pad_id = self.tokenizer.pad_token_id
        infer_samples = dict(samples)
        infer_samples["Answer"] = [""] * len(samples["Question"])
        batch = self.prepare_batch(infer_samples)
        # strip the empty answer ([OUTPUT][END]): decode begins at [OUTPUT]
        output_ids = self._ids("[OUTPUT]")
        trim = len(output_ids) + len(self._ids("[END]"))
        prompt_ids = batch.input_ids[:, :-trim] if trim else batch.input_ids
        prompt_ids = np.concatenate(
            [prompt_ids, np.tile(np.asarray(output_ids)[None], (prompt_ids.shape[0], 1))],
            axis=1)
        # right-pad to a 32-token bucket: prompt_len below masks the pad
        bucket = 32
        L = prompt_ids.shape[1]
        target = ((L + bucket - 1) // bucket) * bucket
        if target != L:
            prompt_ids = np.concatenate(
                [prompt_ids, np.full((prompt_ids.shape[0], target - L), pad_id,
                                     prompt_ids.dtype)], axis=1)
        # The slot rows cut or padded to the bucket. The reference only cuts
        # them, and a prompt with a modality slot that needs padding then
        # fails in its splice (ROADMAP C10).
        width = prompt_ids.shape[1]

        def fit(v, fill):
            v = v[:, :width]
            return np.pad(v, ((0, 0), (0, width - v.shape[1])), constant_values=fill)

        batch_p = dataclasses.replace(
            batch, input_ids=prompt_ids,
            slot_mask={m: fit(v, False) for m, v in batch.slot_mask.items()},
            slot_index={m: fit(v, 0) for m, v in batch.slot_index.items()})
        modality_embeds = self.encode_modalities(batch_p)
        embeds = (self._splice_embeds(batch_p, modality_embeds)
                  if self.llama_proj is not None else
                  self.llm.embed(self._tensor(prompt_ids)))
        # true prompt length = 1 + the last real position; modality slots
        # hold pad_id but are real (their embeddings were spliced in)
        real = prompt_ids != pad_id
        for mask in batch_p.slot_mask.values():
            real = real | mask
        last = real.shape[1] - 1 - np.argmax(real[:, ::-1], axis=1)
        prompt_len = torch.as_tensor(np.maximum(last + 1, 1), dtype=torch.int32)
        gen_cfg = GenerateConfig(
            max_new_tokens=max_new_tokens or self.max_context_len,
            eos_ids=(self._end_id, self.tokenizer.eos_token_id), pad_id=pad_id,
            collect_layers=self.alignment_layer)
        out = generate(self.llm, embeds, prompt_len, gen_cfg, generator)
        tokens = out["tokens"].cpu().numpy()          # [B, N]
        step_hidden = out["step_hidden"]              # [N-1, K, B, H], on the device
        text = self.tokenizer.decode([t for t in tokens[0] if t != pad_id],
                                     skip_special_tokens=False)
        output_texts = text.split("[END]")[0]
        answers.append(output_texts)

        for modality in tags.get_llm_text_modality(output_texts, list(self.modality_tokens)):
            caps = (get_llm_text_res_train(output_texts, modality)
                    or tags.get_llm_text_res(output_texts, modality))
            for mi, cap in enumerate(caps):
                predictions_text[modality].append(cap)
                pred = self._decode_modality_infer(modality, mi, cap, tokens, step_hidden,
                                                   samples, guidance_scale,
                                                   num_inference_steps)
                if pred is None:
                    continue
                if modality == "BOX":
                    predictions["BOX"]["bboxes"].append(pred["outputs_bboxes"][0])
                    predictions["BOX"]["label_names"].append(pred["outputs_label_names"][0])
                    predictions["BOX"]["scores"].append(pred["outputs_scores"][0])
                else:
                    predictions[modality].append(pred)
        return answers, predictions, predictions_text

    @torch.inference_mode()
    def _decode_modality_infer(self, modality: str, occurrence: int, cap: str,
                               tokens: np.ndarray, step_hidden, samples,
                               guidance_scale: float, num_inference_steps: int):
        """Project the generated signal tokens' hidden states and drive the
        decoder with 0.1 * projected + 0.9 * its text conditioning. tokens:
        [B, N] numpy; step_hidden: [N-1, K, B, H] (a tensor or numpy)."""
        pipe = self.diffusion_pipes.get(modality)
        if modality in ("IMAGE", "VIDEO", "AUDIO") and pipe is None:
            logging.info("no %s generation model.", modality)
            return None
        if modality == "BOX":
            if self.box_decoder is None or "Image_ori_array" not in samples:
                return None
            res = self.box_decoder(samples["Image_ori_array"][0], cap)
            return dict(outputs_bboxes=[res["bboxes"]],
                        outputs_label_names=[res["label_names"]],
                        outputs_scores=[res["scores"]])
        if modality == "MASK":
            if self.sam is None:
                return None
            return self._decode_mask_infer(occurrence, cap, tokens, step_hidden, samples)

        # the occurrence-th run of [X0..Xn] among the generated tokens
        sig_ids = self._signal_ids[modality]
        pos = np.where(tokens[0] == sig_ids[0])[0]
        proj = None
        if len(pos) > occurrence:
            step_hidden = torch.as_tensor(step_hidden)
            start = int(pos[occurrence])
            idx = np.arange(start, start + len(sig_ids))
            idx = idx[idx < step_hidden.shape[0]]
            if len(idx):
                taps = step_hidden[torch.as_tensor(idx, device=step_hidden.device), :, 0]
                fused = taps.sum(dim=1)[None]                    # [1, n, H]
                proj = self._apply_aligner(modality, fused.to(self.device))

        cond = pipe(prompt=[cap], return_prompts_only=True)
        if proj is not None:
            cond = torch.as_tensor(cond).to(proj.device)
            if cond.ndim == 2:          # a pooled conditioning (AudioLDM's CLAP)
                proj = proj[:, 0]
            prompt_embeds = 0.1 * proj.float() + 0.9 * cond.float()
        else:
            prompt_embeds = cond
        result = pipe(prompt_embeds=prompt_embeds, guidance_scale=guidance_scale,
                      num_inference_steps=num_inference_steps)
        return result[0] if modality in ("IMAGE", "AUDIO") else result

    @torch.inference_mode()
    def _decode_mask_infer(self, occurrence: int, cap: str, tokens: np.ndarray, step_hidden,
                           samples) -> Optional[np.ndarray]:
        """The box decoder's top box for `cap`, rescaled from the original
        image to the SAM input, prompts SAM (spider_tpu/models/spider.py:725-740):
        low-res masks [1, 4h, 4w] fp32 on the host, or None without a box
        decoder, an IMAGE_SAM input or a detection."""
        if self.box_decoder is None or "IMAGE_SAM" not in samples:
            return None
        det = self.box_decoder(samples["Image_ori_array"][0], cap)
        if not det["bboxes"]:
            return None
        oh, ow = samples["Meta_info"]["original_shape"][0]
        sh, sw = samples["Meta_info"]["sam_shape"][0]
        box = np.asarray(det["bboxes"][0], np.float32) * np.array(
            [sw / ow, sh / oh, sw / ow, sh / oh], np.float32)
        dev = self.sam.device
        image = torch.as_tensor(np.asarray(samples["IMAGE_SAM"][0]), dtype=torch.float32)
        masks = self.sam.predict_box(image[None].to(dev), torch.from_numpy(box)[None, None].to(dev))
        return masks[0].float().cpu().numpy()

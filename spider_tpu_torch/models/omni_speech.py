"""Qwen2.5-Omni speech pipeline in PyTorch (counterpart of
spider_tpu/models/omni_speech.py): thinker -> talker -> token2wav, text and
speech out of one call.

  1. the thinker (models/qwen_omni.QwenOmniThinker) decodes the text reply
     and captures the talker's conditioning streams (last-layer hidden +
     token embedding per position);
  2. the talker (models/omni_talker.OmniTalker) draws speech-codec tokens
     from those streams, the speaker's text-BOS row spliced between prompt
     and reply;
  3. token2wav (models/omni_token2wav.OmniToken2Wav) turns the codec tokens
     into mel (DiT flow matching, speaker-conditioned) and then a waveform
     (BigVGAN).

Speakers follow the HF ``spk_dict.pt`` entries: ``bos_token`` (a tts text id
in the thinker's vocabulary), ``cond`` (the DiT conditioning vector) and
``ref_mel`` (the ECAPA reference mel). Randomness comes from explicit
``torch.Generator``s: the talker's draws from one, the DiT's initial noise
from another made from the same seed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from spider_tpu_torch.models.omni_talker import (OmniTalker, OmniTalkerGenerator,
                                                 TalkerSampling)
from spider_tpu_torch.models.omni_token2wav import OmniToken2Wav
from spider_tpu_torch.models.qwen_omni import QwenOmniThinker


@dataclasses.dataclass
class OmniSpeaker:
    """One entry of the speaker dictionary (HF spk_dict.pt)."""

    bos_token: int                 # tts text-BOS id in the thinker vocab
    cond: np.ndarray               # [1, enc_emb_dim] DiT conditioning
    ref_mel: np.ndarray            # [1, T_ref, mel_dim] ECAPA reference mel


class OmniSpeechPipeline:
    """chat_with_speech(): the text reply and its waveform.

    The talker's prefill is [prompt rows, the speaker's text-BOS row, the
    first reply row] with the codec PAD/BOS embeddings added at the last two
    rows; its decode feeds the reply rows, then text-EOS, then text-PAD; the
    codec ids drive the DiT and BigVGAN."""

    def __init__(self, thinker: QwenOmniThinker, talker: OmniTalker, token2wav: OmniToken2Wav,
                 speakers: Optional[Dict[str, OmniSpeaker]] = None,
                 sampling: Optional[TalkerSampling] = None):
        self.thinker = thinker
        self.talker = talker
        self.token2wav = token2wav
        self.speakers = speakers or {}
        self.generator = OmniTalkerGenerator(talker, sampling)

    def _embed_text_id(self, tid: int) -> np.ndarray:
        """A thinker-vocabulary id through the thinker's embedding table (HF
        embeds the tts text ids with thinker.model.embed_tokens)."""
        return self.thinker.embed_ids([tid])[0].float().cpu().numpy()

    def default_speaker(self) -> OmniSpeaker:
        """The first speaker of the dictionary, or without one a neutral voice:
        the generic text-BOS id, zero conditioning and a zero reference mel
        of two DiT blocks."""
        if self.speakers:
            return next(iter(self.speakers.values()))
        dcfg = self.token2wav.dit.config
        return OmniSpeaker(bos_token=self.talker.config.text_bos,
                           cond=np.zeros((1, dcfg.enc_emb_dim), np.float32),
                           ref_mel=np.zeros((1, 2 * dcfg.block_size, dcfg.mel_dim), np.float32))

    def talk(self, streams: Dict[str, np.ndarray], speaker: OmniSpeaker,
             max_speech_tokens: Optional[int] = None,
             generator: Optional[torch.Generator] = None) -> np.ndarray:
        """The talker's codec ids over captured thinker streams. The prefill
        positions are the thinker's m-RoPE prompt positions extended by two
        sequential rows (the speaker's text-BOS and the first reply row) on
        all three streams. Only ids the DiT has a codebook row for are drawn,
        and EOS or PAD (ROADMAP C15)."""
        cfg = self.talker.config
        pos = np.asarray(streams["positions"], np.int32)  # [3, 1, P]
        nxt = int(pos.max()) + 1
        ext = np.broadcast_to(np.asarray([nxt, nxt + 1], np.int32), (3, 1, 2))
        return self.generator.generate(
            streams["prompt_stream"], self._embed_text_id(int(speaker.bos_token)),
            streams["reply_stream"], self._embed_text_id(cfg.text_eos),
            self._embed_text_id(cfg.text_pad),
            prefill_positions=np.concatenate([pos, ext], axis=-1),
            max_new_tokens=max_speech_tokens, generator=generator,
            voiceable=self.token2wav.dit.config.num_embeds + 1)

    def speak(self, streams: Dict[str, np.ndarray], speaker: Optional[OmniSpeaker] = None,
              max_speech_tokens: Optional[int] = None, num_flow_steps: int = 10,
              guidance_scale: float = 0.5, seed: int = 0,
              noise: Optional[torch.Tensor] = None) -> np.ndarray:
        """Talker + token2wav over captured thinker streams -> waveform fp32.
        The talker draws from a generator seeded with `seed`, the DiT's noise
        (unless `noise` is given) from another seeded with `seed` + 1."""
        speaker = speaker or self.default_speaker()
        dev = self.talker.device
        codes = self.talk(streams, speaker, max_speech_tokens,
                          torch.Generator(device=dev).manual_seed(seed))
        if codes.size == 0:
            return np.zeros((0,), np.float32)
        wav_dev = self.token2wav.dit.proj_out.weight.device
        return np.asarray(self.token2wav(
            codes[None], speaker.cond, speaker.ref_mel, num_steps=num_flow_steps,
            guidance_scale=guidance_scale,
            generator=torch.Generator(device=wav_dev).manual_seed(seed + 1), noise=noise),
            np.float32)

    def chat_with_speech(self, prompt: str, audios=None, images=None, videos=None,
                         speaker: Optional[str] = None,
                         max_speech_tokens: Optional[int] = None, num_flow_steps: int = 10,
                         guidance_scale: float = 0.5, seed: int = 0):
        """(reply text, waveform float32 [T_wav]). An unknown speaker name
        raises KeyError."""
        text, streams = self.thinker.chat(prompt, audios=audios, images=images, videos=videos,
                                          return_talker_streams=True)
        spk = self.speakers.get(speaker) if speaker else None
        if speaker and spk is None:
            raise KeyError(f"unknown speaker {speaker!r}; have {sorted(self.speakers)}")
        wav = self.speak(streams, speaker=spk, max_speech_tokens=max_speech_tokens,
                         num_flow_steps=num_flow_steps, guidance_scale=guidance_scale,
                         seed=seed)
        return text, wav


# ------------------------------------------------------------------ builders

def build_tiny_omni_speech(*, device="cpu", seed: int = 0) -> OmniSpeechPipeline:
    """Test-scale pipeline (tiny thinker, talker and token2wav), random from
    `seed`, fp32."""
    from spider_tpu_torch.models.omni_talker import build_tiny_talker
    from spider_tpu_torch.models.omni_token2wav import build_tiny_token2wav
    from spider_tpu_torch.models.qwen_omni import build_tiny_omni_thinker

    thinker = build_tiny_omni_thinker(device=device, seed=seed)
    # the talker embeds codec tokens at the thinker's width (the streams sum)
    talker = build_tiny_talker(device=device, seed=seed + 1,
                               embedding_size=thinker.llm.config.hidden_size)
    return OmniSpeechPipeline(thinker, talker, build_tiny_token2wav(device=device, seed=seed + 2))


def read_speakers(spk_path: str) -> Dict[str, OmniSpeaker]:
    """HF ``spk_dict.pt``: {name: {bos_token, cond, ref_mel}} read with
    ``torch.load(..., weights_only=True)``, as the reference reads it."""
    speakers: Dict[str, OmniSpeaker] = {}
    for name, entry in torch.load(spk_path, map_location="cpu", weights_only=True).items():
        ref = np.asarray(entry["ref_mel"], np.float32)
        speakers[name] = OmniSpeaker(
            bos_token=int(entry["bos_token"]),
            cond=np.asarray(entry["cond"], np.float32).reshape(1, -1),
            ref_mel=ref[None] if ref.ndim == 2 else ref)
    return speakers


def build_full_omni_speech(ckpt_path: Optional[str] = None, spk_path: Optional[str] = None, *,
                           device="cuda", dtype: torch.dtype = torch.bfloat16,
                           max_new_tokens: int = 512, seed: int = 0) -> OmniSpeechPipeline:
    """Qwen2.5-Omni-7B on `device`: the thinker and the talker in `dtype`
    (the talker's parameters held in `dtype`, the bf16 its products round
    them to), token2wav in fp32. With ckpt_path, the HF checkpoint's
    ``thinker.``, ``talker.`` and ``token2wav.`` keys (the thinker's and
    the talker's widths and depths from its config.json where it has one); otherwise random from `seed`. spk_path
    names a ``spk_dict.pt``."""
    from spider_tpu_torch.models import convert as C
    from spider_tpu_torch.models.factory import random_init_
    from spider_tpu_torch.models.omni_talker import talker_full
    from spider_tpu_torch.models.omni_token2wav import BigVGAN, DiTModel, bigvgan_full, dit_full
    from spider_tpu_torch.models.qwen_omni import build_full_omni_thinker

    thinker = build_full_omni_thinker(ckpt_path, device=device, dtype=dtype,
                                      max_new_tokens=max_new_tokens, seed=seed)
    tcfg = dataclasses.replace(talker_full(), dtype=dtype, param_dtype=dtype,
                               **C.read_omni_config(ckpt_path).get("talker", {}))
    talker = OmniTalker(tcfg, device).eval()
    dit, voc = DiTModel(dit_full(), device).eval(), BigVGAN(bigvgan_full(), device).eval()
    if ckpt_path:
        C.load_omni_speech(ckpt_path, talker, dit, voc)
    else:
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        for mod in (talker, dit, voc):
            random_init_(mod, gen)
    speakers = read_speakers(spk_path) if spk_path else {}
    return OmniSpeechPipeline(thinker, talker, OmniToken2Wav(dit, voc), speakers=speakers)


def default_spk_path(ckpt_path: Optional[str]) -> Optional[str]:
    """``<ckpt_path>/spk_dict.pt`` where the checkpoint directory has one."""
    if ckpt_path and os.path.isfile(os.path.join(ckpt_path, "spk_dict.pt")):
        return os.path.join(ckpt_path, "spk_dict.pt")
    return None

"""Tag grammar of Spider's any-to-many responses.

The LLM emits text with ``<X>caption</X>`` spans (X in IMAGE/VIDEO/AUDIO/
MASK/BOX/IMAGESTORY); stories carry a nested grammar
``<IMAGESTORY><GENERALPROMPT>..</GENERALPROMPT>, <PROMPTARRAY>[..]</PROMPTARRAY>,
<STYLENAME>..</STYLENAME></IMAGESTORY>``. A copy of spider_tpu/models/tags.py
(pure Python), including DeepSeek-R1 ``</think>`` stripping and the
permissive prompt-array cleanup.
"""

from __future__ import annotations

import ast
import json
import re
from typing import List, Sequence, Tuple

MODALITY_KEYS = ("IMAGE", "VIDEO", "AUDIO", "MASK", "BOX", "IMAGESTORY")

STYLE_NAMES = ("Japanese Anime", "Digital/Oil Painting", "Photographic", "Comic book")


def get_llm_text_res(string: str, modality: str) -> List[str]:
    """All captions inside <MODALITY>...</MODALITY> spans."""
    return re.findall(rf"<{modality}>(.*?)</{modality}>", string, re.DOTALL)


def get_llm_text_modality(string: str, modality_keys: Sequence[str] = MODALITY_KEYS
                          ) -> List[str]:
    """Which of modality_keys appear as complete tag spans, in key order."""
    found = []
    for modality in modality_keys:
        if re.search(rf"<{modality}>.*?</{modality}>", string, re.DOTALL):
            found.append(modality)
    return found


def strip_think(text: str) -> str:
    """Keep only content after the last opening reasoning block's close —
    the split is on the FIRST '</think>'."""
    parts = text.split("</think>", 1)
    return parts[1] if len(parts) > 1 else text


def clean_prompt_array(prompt_str: str) -> List[str]:
    """Parse a prompt array in any of: Python list, JSON array, quoted/newline
    separated items, possibly wrapped in markup."""
    if not prompt_str.strip():
        return []
    prompt_str = re.sub(r"<.*?>", "", prompt_str).strip()
    try:
        parsed = ast.literal_eval(prompt_str)
        if isinstance(parsed, list):
            return [str(item).strip() for item in parsed if item]
    except (SyntaxError, ValueError):
        pass
    try:
        parsed = json.loads(prompt_str)
        if isinstance(parsed, list):
            return [str(item).strip() for item in parsed if item]
    except json.JSONDecodeError:
        pass
    prompt_str = re.sub(r"^\[|\]$", "", prompt_str.strip())
    prompts = re.split(r"'\s*,\s*'|\"\s*,\s*\"|\n", prompt_str)
    return [p.strip(" '\"") for p in prompts if p.strip()]


def extract_story_elements(output_texts: str) -> Tuple[str, List[str], str]:
    """(general_prompt, prompt_array, style_name); last occurrence wins."""
    output_texts = strip_think(output_texts)
    gp = re.findall(r"<GENERALPROMPT>\s*(.*?)\s*</GENERALPROMPT>", output_texts, re.DOTALL)
    general_prompt = gp[-1].strip() if gp else ""
    pa = re.findall(r"<PROMPTARRAY>\s*(.*?)\s*</PROMPTARRAY>", output_texts, re.DOTALL)
    prompt_array = clean_prompt_array(pa[-1].strip() if pa else "[]")
    sn = re.findall(r"<STYLENAME>\s*(.*?)\s*</STYLENAME>", output_texts, re.DOTALL)
    style_name = sn[-1].strip() if sn else ""
    # Models sometimes quote the fields.
    general_prompt = general_prompt.strip("'\"")
    style_name = style_name.strip("'\"")
    return general_prompt, prompt_array, style_name


def split_on_placeholders(text: str, modalities: Sequence[str]) -> List[Tuple[str, str]]:
    """Split instruction text on '<X><X-Placeholder></X>' markups.

    Returns a list of ("text", span) and ("modality", X) pieces in order —
    used for prompt assembly.
    """
    pattern = "|".join(
        rf"<{m}><{m}-Placeholder></{m}>" for m in modalities
    )
    pieces: List[Tuple[str, str]] = []
    pos = 0
    for m in re.finditer(pattern, text):
        if m.start() > pos:
            pieces.append(("text", text[pos:m.start()]))
        tag = m.group()
        modality = tag[1:tag.index(">")]
        pieces.append(("modality", modality))
        pos = m.end()
    if pos < len(text):
        pieces.append(("text", text[pos:]))
    return pieces

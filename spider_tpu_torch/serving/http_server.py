"""Headless web demo: a stdlib HTTP JSON API (counterpart of
spider_tpu/serving/http_server.py, the reference's Gradio front ends made
headless). POST /chat with {"text": ...} -> {"answer": ..., "events": [...]}
with media base64-encoded, or with {"stream": true} server-sent events, one
as each decoder finishes; GET / serves a minimal chat page. A copy of the
JAX package's server (it imports no JAX); PIL is imported only where an
image is encoded or decoded.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

_PAGE = """<!doctype html><html><head><title>spider-tpu</title><style>
body{font-family:sans-serif;max-width:900px;margin:2em auto}
#hist{border:1px solid #ccc;padding:1em;min-height:120px}
.turn{margin-bottom:1em}.u{color:#246}.media img{max-width:256px;margin:2px}
video,audio{display:block;margin:4px 0}</style></head>
<body><h2>spider-tpu any-to-many chat</h2>
<div id=hist></div>
<textarea id=q rows=3 cols=80 placeholder="Ask for text + any media..."></textarea><br>
Output modality:
<select id=task>
 <option>TEXT</option><option>IMAGE</option><option>VIDEO</option>
 <option>AUDIO</option><option>MASK</option><option>BOX</option>
 <option>SMARTMULTIMODAL</option><option>IMAGESTORY</option>
</select><br>
Image: <input type=file id=img accept="image/*">
Audio: <input type=file id=aud accept="audio/*">
Video frames: <input type=file id=vid accept="image/*" multiple><br>
<button onclick="send()">Send</button>
<script>
function b64(file){return new Promise(res=>{const r=new FileReader();
 r.onload=()=>res(r.result.split(',')[1]);r.readAsDataURL(file);});}
function render(ev){
 if(ev.kind=='image'||ev.kind=='mask')
   return '<img src="data:image/png;base64,'+ev.data+'" title="'+(ev.caption||'')+'"/>';
 if(ev.kind=='audio')
   return '<audio controls src="data:audio/wav;base64,'+ev.data+'"></audio>';
 if(ev.kind=='video'||ev.kind=='story'){
   const id='v'+Math.random().toString(36).slice(2);
   if(ev.kind=='story')
     return '<div class=media>'+ev.data.map(f=>'<img src="data:image/png;base64,'+f+'"/>').join('')+'</div>';
   // video: flipbook over returned frames
   let html='<img id="'+id+'" src="data:image/png;base64,'+ev.data[0]+'"/>';
   html+='<script>(function(){let i=0;setInterval(()=>{const el=document.getElementById("'+id+'");'
     +'if(el){i=(i+1)%'+ev.data.length+';el.src="data:image/png;base64,"+'+JSON.stringify(ev.data)+'[i];}},125);})()<'+'/script>';
   return html;
 }
 if(ev.kind=='box')
   return '<pre>'+JSON.stringify({bboxes:ev.bboxes,labels:ev.labels,scores:ev.scores})+'</pre>';
 return '';
}
async function send(){
 const body={text:document.getElementById('q').value,
             task:document.getElementById('task').value};
 const img=document.getElementById('img').files[0];
 if(img) body.image=await b64(img);
 const aud=document.getElementById('aud').files[0];
 if(aud) body.audio=await b64(aud);
 const vids=document.getElementById('vid').files;
 if(vids.length) body.video_frames=await Promise.all([...vids].map(b64));
 body.stream=true;
 const hist=document.getElementById('hist');
 hist.innerHTML+='<div class=turn><b class=u>you:</b> '+body.text+'</div>';
 const turn=document.createElement('div');turn.className='turn';
 turn.innerHTML='<b>spider:</b> <span class=ans>…</span><div class=media></div>';
 hist.appendChild(turn);
 // per-tag streaming: each SSE event renders the moment its decoder
 // finishes (image/audio appear while the video stage still denoises)
 const r=await fetch('/chat',{method:'POST',
   headers:{'Content-Type':'application/json'},body:JSON.stringify(body)});
 const reader=r.body.getReader();const dec=new TextDecoder();let buf='';
 for(;;){
  const {done,value}=await reader.read();
  if(done)break;
  buf+=dec.decode(value,{stream:true});
  let i;
  while((i=buf.indexOf('\\n\\n'))>=0){
   const chunk=buf.slice(0,i);buf=buf.slice(i+2);
   if(!chunk.startsWith('data: '))continue;
   const ev=JSON.parse(chunk.slice(6));
   if(ev.kind=='text')turn.querySelector('.ans').textContent=ev.answer;
   else if(ev.kind=='error')turn.querySelector('.ans').textContent='error: '+ev.error;
   else if(ev.kind!='done')turn.querySelector('.media').innerHTML+=render(ev);
  }
 }
}
</script></body></html>"""


def _encode_image(arr: np.ndarray) -> str:
    from PIL import Image

    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _encode_wav(wave: np.ndarray, sample_rate: int = 16000) -> str:
    import struct
    import wave as wavmod

    pcm = (np.clip(np.asarray(wave).reshape(-1), -1, 1) * 32767).astype("<i2")
    buf = io.BytesIO()
    with wavmod.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return base64.b64encode(buf.getvalue()).decode()


def serialize_event(kind: str, payload: Any) -> dict:
    if kind in ("image", "mask", "story"):
        if kind == "story":
            return {"kind": "story",
                    "data": [_encode_image(im) for im in payload["images"]]}
        media = payload["media"] if isinstance(payload, dict) else payload
        return {"kind": kind, "data": _encode_image(media),
                "caption": payload.get("caption", "") if isinstance(payload, dict) else ""}
    if kind == "audio":
        media = payload["media"] if isinstance(payload, dict) else payload
        return {"kind": "audio", "data": _encode_wav(media)}
    if kind == "video":
        media = payload["media"] if isinstance(payload, dict) else payload
        frames = [_encode_image(f) for f in np.asarray(media)[0]] \
            if np.asarray(media).ndim == 5 else \
            [_encode_image(f) for f in np.asarray(media)]
        return {"kind": "video", "data": frames}
    if kind == "box":
        return {"kind": "box", **{k: v for k, v in payload.items()}}
    return {"kind": kind, "data": str(payload)}


def build_ask_info(req: dict) -> dict:
    """Assemble decoder-side inputs from a request: base64 'image' ->
    Image_ori_array + IMAGE_SAM +
    Meta_info so the MASK/BOX decoders can run; 'audio'/'video' payloads are
    forwarded raw for the chat backbone."""
    import numpy as np

    ask: dict = {}
    if req.get("image"):
        from PIL import Image

        from spider_tpu_torch.processors.vision import sam_preprocess

        raw = base64.b64decode(req["image"])
        img = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
        sam_img, sam_hw = sam_preprocess(img)
        ask["Image_ori_array"] = [img]
        ask["IMAGE_SAM"] = [sam_img]
        ask["Meta_info"] = {"original_shape": [img.shape[:2]],
                            "sam_shape": [sam_hw]}
    return ask


def decode_mm_inputs(req: dict):
    """(audios, images, videos) understanding inputs for the chat backbone:
    'audio' =
    base64 wav -> float waveform; 'image' = base64 png/jpg -> HWC array;
    'video_frames' = list of base64 frames -> [F, H, W, 3]."""
    import wave as wavmod

    from PIL import Image

    audios = images = videos = None
    if req.get("audio"):
        with wavmod.open(io.BytesIO(base64.b64decode(req["audio"]))) as w:
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        audios = [pcm.astype(np.float32) / 32767.0]
    if req.get("image"):
        raw = base64.b64decode(req["image"])
        images = [np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))]
    if req.get("video_frames"):
        frames = [np.asarray(Image.open(io.BytesIO(base64.b64decode(f)))
                             .convert("RGB"))
                  for f in req["video_frames"]]
        videos = [np.stack(frames)]
    return audios, images, videos


def make_handler(spider_free):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            logging.debug(*args)

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(_PAGE.encode())

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            mm_kwargs = {}
            # Uploaded audio / video frames only make sense as understanding
            # inputs, so they always route through the chat backbone (which
            # raises if it is text-only — never silently dropped). Images stay
            # decoder-side (MASK/BOX Meta_info via build_ask_info) unless the
            # request explicitly opts into mm understanding.
            if (req.get("mm_understanding") or req.get("audio")
                    or req.get("video_frames")):
                audios, images, videos = decode_mm_inputs(req)
                if not req.get("mm_understanding"):
                    images = None
                mm_kwargs = dict(audios=audios, images=images, videos=videos)
            if req.get("stream"):
                return self._do_stream(req, mm_kwargs)
            try:
                events, answers, _, _ = spider_free.chat(
                    req.get("text", ""), extra_inputs=build_ask_info(req),
                    task_prompt=req.get("task", "TEXT"), **mm_kwargs)
            except ValueError as exc:   # e.g. text-only backbone + audio
                body = json.dumps({"error": str(exc)}).encode()
                self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)
                return
            body = json.dumps({
                "answer": answers[0] if answers else "",
                "events": [serialize_event(k, p) for k, p in events
                           if k != "text"],
            }).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(body)

        def _do_stream(self, req, mm_kwargs):
            """Server-sent events: each chat event is written and flushed
            the moment its decoder finishes, so the browser renders the
            text + fast media (image/audio/box) while the video stage is
            still denoising, the reference's per-tag streaming."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()

            def emit(obj):
                self.wfile.write(b"data: " + json.dumps(obj).encode()
                                 + b"\n\n")
                self.wfile.flush()

            try:
                for kind, payload in spider_free.chat_stream(
                        req.get("text", ""),
                        extra_inputs=build_ask_info(req),
                        task_prompt=req.get("task", "TEXT"), **mm_kwargs):
                    if kind == "text":
                        emit({"kind": "text", "answer": payload})
                    else:
                        emit(serialize_event(kind, payload))
            except Exception as exc:   # noqa: BLE001 — any decoder failure
                # mid-stream must still surface an error + done event (the
                # browser otherwise hangs on the '…' placeholder)
                logging.exception("chat stream failed")
                emit({"kind": "error",
                      "error": f"{type(exc).__name__}: {exc}"})
            emit({"kind": "done"})

    return Handler


def serve(spider_free, host: str = "127.0.0.1", port: int = 7860,
          background: bool = False):
    server = ThreadingHTTPServer((host, port), make_handler(spider_free))
    if background:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server
    logging.info("serving on http://%s:%d", host, port)
    server.serve_forever()

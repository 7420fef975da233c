"""Browser UI.

Port of turbo_whisper_workspace_tpu/serve/ui.py; the page and the Gradio
app run the pipeline on the server's device. The reference ships a
Gradio Blocks app (vocalis/ui/app.py: chat-bubble transcript by speaker
parity `:175-192`, analysis tab with four plots `:519-553`, performance
block with realtime factor `:93-99`). Without Gradio, the UI is a
dependency-free single page served by the API process (GET /ui) that
drives the same HTTP routes; `run_gradio_ui()` provides the Gradio
variant when the package exists.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)

INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>Turbo-Whisper Workspace</title>
<style>
 body{background:#121212;color:#ddd;font-family:sans-serif;max-width:900px;
      margin:2em auto;padding:0 1em}
 h1{color:#4fc3f7} .card{background:#1e1e1e;border-radius:8px;padding:1em;
      margin:1em 0}
 .bubble{border-radius:12px;padding:.6em 1em;margin:.4em 0;max-width:80%}
 .s0{background:#15384a;margin-right:auto} .s1{background:#274a27;margin-left:auto}
 button{background:#4fc3f7;border:0;border-radius:6px;padding:.5em 1.2em;
      font-weight:bold;cursor:pointer} img{max-width:100%}
 label{margin-right:1em}
</style></head><body>
<h1>Turbo-Whisper Workspace</h1>
<div class="card">
 <input type="file" id="file" accept=".wav,.flac,.mp3"/>
 <label>speakers <input id="nspk" type="number" value="2" min="0" max="10"
        style="width:4em"/></label>
 <label>task <select id="task"><option>transcribe</option>
        <option>translate</option></select></label>
 <label>segmentation <select id="segmodel"></select></label>
 <label>embedding <select id="embmodel"></select></label>
 <label>threshold <input id="thr" type="number" value="0.5" min="0" max="1"
        step="0.05" style="width:4.5em"/></label>
 <label>min threat <input id="mtl" type="number" value="2" min="1" max="5"
        style="width:3em"/></label>
 <button onclick="transcribe()">Transcribe</button>
 <button onclick="analyze()">Analyze</button>
 <button onclick="security()">Security scan</button>
 <div id="status"></div>
</div>
<div class="card" id="conv"></div>
<div class="card" id="meta"></div>
<div class="card" id="plots"></div>
<script>
// populate model dropdowns from the registry (reference UI's live
// dropdowns, vocalis/ui/app.py:557-573)
(async function(){
  try{
    const r = await fetch('/api/models'); const m = await r.json();
    const seg = document.getElementById('segmodel');
    for(const s of m.segmentation_models||[]) seg.add(new Option(s, s));
    const emb = document.getElementById('embmodel');
    for(const fam of Object.values(m.embedding_models||{}))
      for(const e of fam) emb.add(new Option(e, e));
  }catch(e){}
})();
async function post(url, extra){
  const f = document.getElementById('file').files[0];
  if(!f){ alert('choose a file'); return null; }
  document.getElementById('status').textContent = 'processing…';
  const fd = new FormData(); fd.append('file', f);
  for(const [k,v] of Object.entries(extra||{})) fd.append(k, v);
  const r = await fetch(url, {method:'POST', body: fd});
  document.getElementById('status').textContent = '';
  return await r.json();
}
async function transcribe(){
  const res = await post('/api/transcribe', {
    num_speakers: document.getElementById('nspk').value,
    task: document.getElementById('task').value,
    segmentation_model: document.getElementById('segmodel').value,
    embedding_model: document.getElementById('embmodel').value,
    threshold: document.getElementById('thr').value,
  });
  if(!res) return;
  const conv = document.getElementById('conv'); conv.innerHTML='';
  const speakers = [...new Set((res.merged_segments||[]).map(s=>s.speaker))];
  for(const s of res.merged_segments||[]){
    const div = document.createElement('div');
    div.className = 'bubble ' + (speakers.indexOf(s.speaker)%2? 's1':'s0');
    div.textContent = s.speaker + ': ' + s.text;
    conv.appendChild(div);
  }
  const pt = res.processing_times||{};
  const rf = pt.total && res.duration ? (pt.total/res.duration).toFixed(2) : '?';
  document.getElementById('meta').innerHTML =
    '<b>Summary:</b> ' + (res.summary||'—') +
    '<br/><b>Topics:</b> ' + ((res.topics||[]).join(', ')||'—') +
    '<br/><b>Realtime factor:</b> ' + rf + '×';
}
async function analyze(){
  const res = await post('/api/analyze');
  if(!res) return;
  const d = document.getElementById('plots'); d.innerHTML='';
  for(const [name,b64] of Object.entries(res.plots||{})){
    const img = document.createElement('img');
    img.src = 'data:image/png;base64,'+b64; d.appendChild(img);
  }
  document.getElementById('meta').textContent =
    JSON.stringify(res.audio_info, null, 1);
}
async function security(){
  const res = await post('/api/security/analyze',
    {min_threat_level: document.getElementById('mtl').value});
  if(!res) return;
  document.getElementById('meta').textContent = res.incident_detected ?
    JSON.stringify(res.incident, null, 1) : 'no incident detected';
}
</script></body></html>
"""


def run_ui(host: str = "0.0.0.0", port: int = 7860, device: str = "cuda") -> None:
    """Serve the UI. Gradio when available, else the static page + API
    on one port."""
    try:
        import gradio  # noqa: F401

        run_gradio_ui(host, port, device)
        return
    except ImportError:
        logger.info("gradio not installed — serving built-in web UI at /ui")
    from .api import serve

    httpd = serve(host, port, device)
    logger.info("open http://%s:%d/ui", host, port)
    httpd.serve_forever()


def run_gradio_ui(host: str = "0.0.0.0", port: int = 7860, device: str = "cuda") -> None:
    """Gradio Blocks app with the reference's tabs (chat + analysis)."""
    import gradio as gr

    from .api import get_pipeline, route_analyze

    from ..utils.registry import embedding2models, speaker_segmentation_models

    def process_chat(audio_path, task, seg_model, emb_model, num_speakers,
                     threshold):
        res = get_pipeline(device).process_audio(
            audio_path, task=task, num_speakers=int(num_speakers),
            threshold=float(threshold),
            segmentation_model=seg_model or None,
            embedding_model=emb_model or None,
        )
        from ..pipeline.diarizer import SpeakerDiarizer

        conv = SpeakerDiarizer.format_as_conversation(res["merged_segments"])
        pt = res.get("processing_times", {})
        rf = (pt.get("total", 0) / res["duration"]) if res.get("duration") else 0
        perf = f"realtime factor: {rf:.2f}x"
        return conv, res.get("summary", ""), ", ".join(res.get("topics", [])), perf

    seg_choices = speaker_segmentation_models()
    emb_choices = [m for fam in embedding2models().values() for m in fam]
    with gr.Blocks(title="Turbo-Whisper Workspace") as demo:
        with gr.Tab("Chat"):
            audio = gr.Audio(type="filepath")
            task = gr.Dropdown(["transcribe", "translate"], value="transcribe",
                               label="task")
            seg = gr.Dropdown(seg_choices, value=seg_choices[0],
                              label="segmentation model")
            emb = gr.Dropdown(emb_choices, value=emb_choices[0],
                              label="embedding model")
            n = gr.Slider(0, 10, value=2, step=1, label="speakers (0=auto)")
            thr = gr.Slider(0.0, 1.0, value=0.5, step=0.05,
                            label="clustering threshold")
            btn = gr.Button("Transcribe")
            conv = gr.Markdown()
            summary = gr.Markdown(label="summary")
            topics = gr.Markdown(label="topics")
            perf = gr.Markdown()
            btn.click(process_chat, [audio, task, seg, emb, n, thr],
                      [conv, summary, topics, perf])
        with gr.Tab("Analysis"):
            audio2 = gr.Audio(type="filepath")
            btn2 = gr.Button("Analyze")
            info = gr.JSON()

            def analyze(p):
                with open(p, "rb") as f:
                    return route_analyze(f.read(), p, {})["audio_info"]

            btn2.click(analyze, [audio2], [info])
    demo.launch(server_name=host, server_port=port)

"""The dashboard's single-page UI: vanilla HTML/JS over the REST API.

Reference: ``dashboard/client/`` (a 21.7k-LoC React app). Scope here is
the operator's tables — cluster summary, nodes, jobs, actors, tasks,
placement groups — polling ``/api/*`` with no build toolchain, plus the
Chrome-trace timeline download. Served by ``DashboardHead`` at ``/``.
"""

INDEX_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>ray-tpu dashboard</title>
<style>
  body { font-family: system-ui, sans-serif; margin: 1.5rem;
         color: #222; }
  h1 { font-size: 1.3rem; }
  h2 { font-size: 1.05rem; margin: 1.4rem 0 .4rem; }
  table { border-collapse: collapse; width: 100%; font-size: .85rem; }
  th, td { border: 1px solid #ddd; padding: .3rem .5rem;
           text-align: left; }
  th { background: #f4f4f4; }
  .pill { padding: .1rem .45rem; border-radius: .6rem;
          font-size: .75rem; }
  .ok { background: #d9f2d9; }
  .bad { background: #f6d3d3; }
  .muted { color: #777; }
  #summary span { margin-right: 1.2rem; }
  a.button { display: inline-block; padding: .25rem .6rem;
             border: 1px solid #888; border-radius: .3rem;
             text-decoration: none; color: #222; }
</style>
</head>
<body>
<h1>ray-tpu dashboard <span id="version" class="muted"></span></h1>
<div id="summary"></div>
<p><a class="button" href="/api/timeline" download="timeline.json">
  Download task timeline (Chrome trace)</a>
<a class="button" href="/timeline" download="perfetto_trace.json">
  Download flight-recorder trace (Perfetto)</a>
<a class="button" href="/api/v0/events">Flight-recorder events (JSON)</a></p>
<h2>Nodes</h2><table id="nodes"></table>
<h2>Worker processes</h2><table id="procs"></table>
<h2>Jobs</h2><table id="jobs"></table>
<h2>Actors</h2><table id="actors"></table>
<h2>Placement groups</h2><table id="pgs"></table>
<h2>Recent tasks</h2><table id="tasks"></table>
<script>
const esc = (s) => s.replace(/&/g, "&amp;").replace(/</g, "&lt;")
  .replace(/>/g, "&gt;").replace(/"/g, "&quot;");
const fmt = (v) => v === null || v === undefined ? "" :
  esc(typeof v === "object" ? JSON.stringify(v) : String(v));
function table(el, rows, cols, raw) {
  if (!rows || !rows.length) {
    el.innerHTML = "<tr><td class='muted'>none</td></tr>"; return;
  }
  cols = cols || Object.keys(rows[0]);
  raw = raw || [];
  let html = "<tr>" + cols.map(c => `<th>${c}</th>`).join("") + "</tr>";
  for (const r of rows) {
    html += "<tr>" + cols.map(c => {
      let v = raw.includes(c) ? (r[c] || "") : fmt(r[c]);
      if (c === "alive" || c === "state" || c === "status") {
        const good = v === "true" || v === "ALIVE" || v === "RUNNING"
          || v === "FINISHED" || v === "SUCCEEDED" || v === "CREATED";
        v = `<span class="pill ${good ? "ok" : "bad"}">${v}</span>`;
      }
      return `<td>${v}</td>`;
    }).join("") + "</tr>";
  }
  el.innerHTML = html;
}
async function j(url) {
  const r = await fetch(url);
  if (!r.ok) throw new Error(url + ": " + r.status);
  return r.json();
}
async function refresh() {
  try {
    const [ver, status, nodes, jobs, actors, pgs, tasks, procs] =
      await Promise.all([
        j("/api/version"), j("/api/cluster_status"),
        j("/api/state/nodes"), j("/api/jobs"),
        j("/api/state/actors"), j("/api/state/placement_groups"),
        j("/api/state/tasks?limit=50"),
        j("/api/state/node_processes")]);
    document.getElementById("version").textContent =
      "v" + ver.version + " — " + ver.ray_tpu_session;
    const st = status.task_states || {};
    document.getElementById("summary").innerHTML =
      `<span><b>${(nodes.rows||[]).length}</b> nodes</span>` +
      `<span><b>${status.num_actors}</b> actors</span>` +
      `<span><b>${status.num_objects}</b> objects</span>` +
      `<span><b>${status.num_pending_tasks}</b> pending tasks</span>` +
      Object.entries(st).map(
        ([k, v]) => `<span class="muted">${k}: ${v}</span>`).join("");
    table(document.getElementById("nodes"), nodes.rows,
      ["node_id", "alive", "resources_total", "resources_available",
       "num_workers", "labels"]);
    // live per-process stats from each node's agent feed; the profile
    // link returns the worker's collapsed-stack flamegraph artifact
    const prows = (procs.rows || []).map(p => ({
      node: (p.node_id || "").slice(0, 12), kind: p.kind, pid: p.pid,
      "cpu %": p.cpu_percent,
      "rss MiB": Math.round((p.rss || 0) / 1048576),
      threads: p.num_threads,
      profile: p.worker_id ?
        `<a class="button" href="/api/nodes/${p.node_id}/profile` +
        `?worker=${p.worker_id}&duration=2">sample</a>` : ""}));
    table(document.getElementById("procs"), prows, null, ["profile"]);
    table(document.getElementById("jobs"), jobs.jobs || jobs);
    table(document.getElementById("actors"), actors.rows,
      ["actor_id", "state", "name", "namespace", "num_restarts",
       "node_id"]);
    table(document.getElementById("pgs"), pgs.rows);
    table(document.getElementById("tasks"),
      (tasks.rows || []).slice(-50).reverse());
  } catch (e) {
    document.getElementById("summary").innerHTML =
      `<span class="pill bad">refresh failed: ${e}</span>`;
  }
}
refresh();
setInterval(refresh, 3000);
</script>
</body>
</html>
"""

"""Post-run HTML report from the results database.

Covers the reference's bokeh/panel report
(``sydr/io/visualisation.py``) with a dependency-light
implementation: matplotlib figures embedded as base64 PNGs in one
self-contained HTML file — acquisition summary, per-channel tracking panels
(C/N0, carrier frequency, discriminators, correlators), position fixes with
ENU errors and statistics against an optional surveyed reference position.
"""

from __future__ import annotations

import base64
import html
import io as _io
import os

import numpy as np

from sydr_tpu_torch.nav import geodesy


def _fig_to_html(fig) -> str:
    buf = _io.BytesIO()
    fig.savefig(buf, format="png", dpi=110, bbox_inches="tight")
    import matplotlib.pyplot as plt

    plt.close(fig)
    data = base64.b64encode(buf.getvalue()).decode()
    return f'<img src="data:image/png;base64,{data}"/>'


def generate_report(
    db,
    out_path: str,
    reference_position=None,
    title: str = "sydr_tpu_torch run report",
) -> str:
    """Render the report; returns the output path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sections: list[str] = [f"<h1>{html.escape(title)}</h1>"]

    # --- Acquisition summary ------------------------------------------------
    acq = db.fetch("acquisition")
    if acq:
        fig, ax = plt.subplots(figsize=(7, 3))
        prns = [r["prn"] for r in acq]
        metrics = [r["metric"] for r in acq]
        ax.bar([f"G{p:02d}" for p in prns], metrics, color="#3b6ea5")
        ax.axhline(1.5, color="r", ls="--", lw=1, label="threshold")
        ax.set_ylabel("peak ratio")
        ax.set_title("Acquisition metric per satellite")
        ax.legend()
        sections.append("<h2>Acquisition</h2>" + _fig_to_html(fig))

        # Doppler x code-phase correlation surfaces (the reference's
        # utils/surface3d.py view), rendered as heatmaps when stored.
        from sydr_tpu_torch.io.database import blob_to_array

        maps = [r for r in acq if r.get("corr_map") is not None]
        if maps:
            cols = min(3, len(maps))
            rows = (len(maps) + cols - 1) // cols
            fig, axes = plt.subplots(
                rows, cols, figsize=(4.2 * cols, 2.8 * rows), squeeze=False)
            for k, r in enumerate(maps):
                m = blob_to_array(r["corr_map"])
                dops = blob_to_array(r["corr_dopplers"])
                ax = axes[k // cols][k % cols]
                ax.imshow(
                    m, aspect="auto", origin="lower", cmap="viridis",
                    extent=(0, m.shape[1], float(dops[0]) / 1e3,
                            float(dops[-1]) / 1e3),
                )
                ax.set_title(f"G{r['prn']:02d} metric={r['metric']:.1f}",
                             fontsize=9)
                ax.set_xlabel("code phase [chips]", fontsize=8)
                ax.set_ylabel("Doppler [kHz]", fontsize=8)
            for k in range(len(maps), rows * cols):
                axes[k // cols][k % cols].axis("off")
            fig.tight_layout()
            sections.append(_fig_to_html(fig))

            # 3-D correlation surface (the reference's vis.js widget,
            # utils/surface3d.py:8-40, as a static render): the strongest
            # acquisition's Doppler x code-phase surface.
            best = max(maps, key=lambda r: r["metric"])
            m = blob_to_array(best["corr_map"])
            dops = blob_to_array(best["corr_dopplers"])
            # decimate the code-phase axis for a drawable mesh
            step = max(1, m.shape[1] // 512)
            ms = m[:, ::step]
            X, Y = np.meshgrid(
                np.arange(0, m.shape[1], step), np.asarray(dops) / 1e3)
            fig = plt.figure(figsize=(7.5, 5))
            ax = fig.add_subplot(111, projection="3d")
            ax.plot_surface(X, Y, ms, cmap="viridis", rstride=1, cstride=1,
                            linewidth=0, antialiased=False)
            ax.set_xlabel("code phase [samples]", fontsize=8)
            ax.set_ylabel("Doppler [kHz]", fontsize=8)
            ax.set_title(
                f"Correlation surface G{best['prn']:02d} "
                f"(metric {best['metric']:.1f})", fontsize=10)
            sections.append("<h3>Correlation surface</h3>"
                            + _fig_to_html(fig))
        rows = "".join(
            f"<tr><td>G{r['prn']:02d}</td><td>{r['doppler']:+.0f}</td>"
            f"<td>{r['code_index']}</td>"
            + (f"<td>{r['code_chips']:.2f}</td>"
               if r.get("code_chips") is not None else "<td>-</td>")
            + f"<td>{r['metric']:.2f}</td></tr>"
            for r in acq
        )
        sections.append(
            "<table border=1 cellpadding=4><tr><th>PRN</th>"
            "<th>Doppler [Hz]</th><th>Code index</th>"
            "<th>Code phase [chips]</th><th>Metric</th></tr>"
            + rows + "</table>"
        )

    # --- Tracking panels ----------------------------------------------------
    track = db.fetch("tracking")
    if track:
        by_ch: dict[int, list[dict]] = {}
        for r in track:
            by_ch.setdefault(r["channel_id"], []).append(r)
        sections.append("<h2>Tracking</h2>")
        for cid, rows in sorted(by_ch.items()):
            rows.sort(key=lambda r: r["epoch"])
            t = np.array([r["epoch"] for r in rows]) * 1e-3
            fig, axes = plt.subplots(2, 2, figsize=(11, 6))
            axes[0, 0].plot(t, [r["cn0"] for r in rows], ".", ms=2)
            axes[0, 0].set_title("C/N0 [dB-Hz]")
            axes[0, 1].plot(t, [r["carrier_freq"] for r in rows], ".", ms=2)
            axes[0, 1].set_title("Carrier frequency [Hz]")
            axes[1, 0].plot(t, [r["dll_error"] for r in rows], ".", ms=2,
                            label="DLL")
            axes[1, 0].plot(t, [r["pll_error"] for r in rows], ".", ms=2,
                            label="PLL")
            axes[1, 0].set_title("Discriminators")
            axes[1, 0].legend()
            axes[1, 1].plot(t, [r["i_prompt"] for r in rows], ".", ms=2,
                            label="IP")
            axes[1, 1].plot(t, [r["q_prompt"] for r in rows], ".", ms=2,
                            label="QP")
            axes[1, 1].set_title("Prompt correlators")
            axes[1, 1].legend()
            for ax in axes.flat:
                ax.set_xlabel("time [s]")
            fig.suptitle(f"Channel {cid}")
            fig.tight_layout()
            sections.append(_fig_to_html(fig))

    # --- Positions ----------------------------------------------------------
    pos = db.fetch("position")
    if pos:
        xyz = np.array([[r["x"], r["y"], r["z"]] for r in pos])
        tow = np.array([r["tow"] for r in pos])
        sections.append("<h2>Position</h2>")
        ref = (np.asarray(reference_position, dtype=np.float64)
               if reference_position is not None else xyz.mean(axis=0))
        enu = np.array([geodesy.ecef_to_enu(p, ref) for p in xyz])

        fig, axes = plt.subplots(1, 2, figsize=(11, 4))
        axes[0].plot(enu[:, 0], enu[:, 1], "o-", ms=3)
        axes[0].axhline(0, color="k", lw=0.5)
        axes[0].axvline(0, color="k", lw=0.5)
        axes[0].set_xlabel("East [m]")
        axes[0].set_ylabel("North [m]")
        axes[0].set_title("Horizontal scatter"
                          + ("" if reference_position is None
                             else " (vs reference)"))
        axes[0].axis("equal")
        t0 = tow - tow[0]
        axes[1].plot(t0, enu[:, 0], label="E")
        axes[1].plot(t0, enu[:, 1], label="N")
        axes[1].plot(t0, enu[:, 2], label="U")
        axes[1].set_xlabel("time [s]")
        axes[1].set_ylabel("error [m]")
        axes[1].set_title("ENU components")
        axes[1].legend()
        fig.tight_layout()
        sections.append(_fig_to_html(fig))

        stats = (
            "<table border=1 cellpadding=4>"
            "<tr><th></th><th>mean [m]</th><th>std [m]</th><th>max [m]</th></tr>"
        )
        for k, name in enumerate(("East", "North", "Up")):
            stats += (
                f"<tr><td>{name}</td><td>{enu[:, k].mean():+.3f}</td>"
                f"<td>{enu[:, k].std():.3f}</td>"
                f"<td>{np.abs(enu[:, k]).max():.3f}</td></tr>"
            )
        norm = np.linalg.norm(enu, axis=1)
        stats += (
            f"<tr><td>3D</td><td>{norm.mean():.3f}</td>"
            f"<td>{norm.std():.3f}</td><td>{norm.max():.3f}</td></tr>"
            "</table>"
        )
        sections.append(stats)

        gdop = [r["gdop"] for r in pos]
        clock = [r["clock_bias"] for r in pos]
        fig, axes = plt.subplots(1, 2, figsize=(11, 3))
        axes[0].plot(t0, clock)
        axes[0].set_title("Clock bias [m]")
        axes[1].plot(t0, gdop)
        axes[1].set_title("GDOP")
        for ax in axes:
            ax.set_xlabel("time [s]")
        fig.tight_layout()
        sections.append(_fig_to_html(fig))

        # Solved velocity + clock drift (Doppler LSE, nav/lse.py:123);
        # rows predating the velocity solve carry NULLs and are skipped.
        vel_rows = [r for r in pos if r.get("vx") is not None]
        if vel_rows:
            vt = np.array([r["tow"] for r in vel_rows]) - tow[0]
            venu = np.array([
                geodesy.ecef_vector_to_enu(
                    np.array([r["vx"], r["vy"], r["vz"]]), ref)
                for r in vel_rows
            ])
            # stored as s/s (nav/lse.py solve_velocity divides by c);
            # render in range-rate units (m/s) to match the label
            drift = np.array(
                [r["clock_drift"] for r in vel_rows]) * 299792458.0
            fig, axes = plt.subplots(1, 2, figsize=(11, 3))
            for k, name in enumerate(("E", "N", "U")):
                axes[0].plot(vt, venu[:, k], label=name)
            axes[0].set_title("Velocity ENU [m/s]")
            axes[0].legend()
            axes[1].plot(vt, drift)
            axes[1].set_title("Clock drift [m/s]")
            for ax in axes:
                ax.set_xlabel("time [s]")
            fig.tight_layout()
            speed = np.linalg.norm(venu, axis=1)
            sections.append(
                "<h3>Velocity</h3>" + _fig_to_html(fig)
                + f"<p>speed mean {speed.mean():.3f} m/s, max "
                f"{speed.max():.3f} m/s; clock drift mean "
                f"{drift.mean():+.3f} m/s</p>")

        # Map view (reference visualisation.py:643-801 renders an OSM tile
        # map; this report is self-contained/offline, so the geodetic track
        # is drawn locally and an OSM link opens the same spot online).
        lla = np.array([geodesy.ecef_to_geodetic(p) for p in xyz])
        lat = np.degrees(lla[:, 0])
        lon = np.degrees(lla[:, 1])
        fig, ax = plt.subplots(figsize=(6, 5))
        ax.plot(lon, lat, ".-", ms=4, color="#3b6ea5", label="fixes")
        if reference_position is not None:
            rl = geodesy.ecef_to_geodetic(np.asarray(reference_position,
                                                     dtype=np.float64))
            rlla = (np.degrees(rl[0]), np.degrees(rl[1]))
            ax.plot([rlla[1]], [rlla[0]], "r*", ms=14, label="reference")
        ax.set_xlabel("longitude [deg]")
        ax.set_ylabel("latitude [deg]")
        ax.set_title("Geodetic track")
        ax.ticklabel_format(useOffset=False, style="plain")
        ax.legend()
        fig.tight_layout()
        osm = (f"https://www.openstreetmap.org/"
               f"?mlat={lat.mean():.6f}&mlon={lon.mean():.6f}#map=16/"
               f"{lat.mean():.6f}/{lon.mean():.6f}")
        sections.append(
            "<h3>Map</h3>" + _fig_to_html(fig)
            + f'<p><a href="{osm}">open mean fix on OpenStreetMap</a></p>')

    # --- Per-stage processing time ------------------------------------------
    timing = db.fetch("timing")
    if timing:
        sections.append("<h2>Processing time</h2>")
        head = ("<table border=1 cellpadding=4><tr><th>stage</th>"
                "<th>count</th><th>mean [ms]</th><th>max [ms]</th>"
                "<th>total [s]</th></tr>")
        body = "".join(
            f"<tr><td>{html.escape(str(r['stage']))}</td>"
            f"<td>{int(r['count'])}</td>"
            f"<td>{r['mean_ms']:.2f}</td>"
            f"<td>{r['max_ms']:.2f}</td>"
            f"<td>{r['total_s']:.2f}</td></tr>"
            for r in sorted(timing, key=lambda r: -r["total_s"])
        )
        sections.append(head + body + "</table>")

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        fh.write(
            "<html><head><meta charset='utf-8'>"
            "<style>body{font-family:sans-serif;margin:2em;}"
            "table{border-collapse:collapse;}</style>"
            f"<title>{html.escape(title)}</title></head><body>"
            + "\n".join(sections)
            + "</body></html>"
        )
    return out_path

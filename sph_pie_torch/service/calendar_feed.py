"""External ICS schedule ingest.

Counterpart of sphereisaiahmin-dev/sph-pie `server/calendarFeed.js`: fetch
an ICS feed, extract per-VEVENT id/title/description/location/start/end/
all-day, derive display metadata from the title (leading event name,
"#<n>" run number, keyword colour), and apply a two-month lookback cutoff.
The reference leans on the node-ical package; here the (small) subset of
RFC 5545 we need is parsed directly: BEGIN:VEVENT blocks, line unfolding,
DATE vs DATE-TIME values.

The fetcher takes an injectable ``opener`` (the reference tests its egress
with a loopback listener; same seam here).
"""

from __future__ import annotations

import re
import time
import urllib.request
from datetime import datetime, timezone

CUTOFF_MONTHS = 2  # reference: 2-month lookback (calendarFeed.js:33-38)

COLOR_KEYWORDS = {
    "DAM": "#4f8ef7",
    "FAUCET": "#31c48d",
    "BENCH": "#f7b24f",
    "PBF": "#b24ff7",
    "DEMO": "#f74f6e",
}
DEFAULT_COLOR = "#8892a6"


def _unfold(text: str) -> list[str]:
    """RFC 5545 line unfolding: a line starting with space/tab continues
    the previous line."""
    out: list[str] = []
    for raw in text.replace("\r\n", "\n").replace("\r", "\n").split("\n"):
        if raw[:1] in (" ", "\t") and out:
            out[-1] += raw[1:]
        else:
            out.append(raw)
    return out


def _parse_dt(prop: str, value: str):
    """Returns (epoch_ms, all_day)."""
    value = value.strip()
    all_day = "VALUE=DATE" in prop and "DATE-TIME" not in prop
    m = re.match(r"^(\d{4})(\d{2})(\d{2})(?:T(\d{2})(\d{2})(\d{2})(Z?))?", value)
    if not m:
        return None, all_day
    y, mo, d = int(m[1]), int(m[2]), int(m[3])
    if m[4] is None:
        dt = datetime(y, mo, d, tzinfo=timezone.utc)
        return int(dt.timestamp() * 1000), True
    tz = timezone.utc  # naive/local treated as UTC (feed convention)
    dt = datetime(y, mo, d, int(m[4]), int(m[5]), int(m[6]), tzinfo=tz)
    return int(dt.timestamp() * 1000), all_day


def parse_event_metadata(title: str) -> dict:
    """Title -> {eventName, number, color} (calendarFeed.js:15-31 shape)."""
    title = str(title or "").strip()
    first = title.split()[0].upper() if title.split() else ""
    number = None
    m = re.search(r"#(\d+)", title)
    if m:
        number = int(m[1])
    else:
        m = re.search(r"\b(\d+)\b", title)
        if m:
            number = int(m[1])
    color = DEFAULT_COLOR
    upper = title.upper()
    for kw, c in COLOR_KEYWORDS.items():
        if kw in upper:
            color = c
            break
    return {"eventName": first, "number": number, "color": color}


def parse_ics(text: str) -> list[dict]:
    events: list[dict] = []
    current: dict | None = None
    for line in _unfold(text):
        if line.startswith("BEGIN:VEVENT"):
            current = {}
        elif line.startswith("END:VEVENT"):
            if current is not None:
                events.append(_finish(current))
            current = None
        elif current is not None and ":" in line:
            prop, value = line.split(":", 1)
            key = prop.split(";")[0].upper()
            if key in ("UID", "SUMMARY", "DESCRIPTION", "LOCATION"):
                current[key.lower()] = value.strip()
            elif key in ("DTSTART", "DTEND"):
                ts, all_day = _parse_dt(prop, value)
                current[key.lower()] = ts
                current.setdefault("all_day", all_day)
    return [e for e in events if e.get("start") is not None]


def _finish(ev: dict) -> dict:
    start = ev.get("dtstart")
    end = ev.get("dtend", start)
    title = ev.get("summary", "")
    return {
        "id": ev.get("uid") or f"ics-{start}",
        "title": title,
        "description": ev.get("description", ""),
        "location": ev.get("location", ""),
        "start": start,
        "end": end,
        "allDay": bool(ev.get("all_day")),
        **parse_event_metadata(title),
    }


def cutoff_timestamp_ms(now_ms: int | None = None) -> int:
    now = now_ms if now_ms is not None else int(time.time() * 1000)
    return now - CUTOFF_MONTHS * 30 * 24 * 3600 * 1000


def fetch_calendar_feed(url: str, opener=None, timeout: float = 10.0) -> list[dict]:
    """Fetch + parse + cutoff-filter an ICS feed."""
    opener = opener or urllib.request.urlopen
    with opener(urllib.request.Request(url), timeout=timeout) as resp:
        text = resp.read().decode("utf-8", errors="replace")
    cutoff = cutoff_timestamp_ms()
    return [e for e in parse_ics(text) if (e["end"] or e["start"]) >= cutoff]

"""Static pages + result-page renderer for the web frontend.

Functional equivalents of the reference site's assets
(website/index.html:1-97, style.css, example.html, and the Go
``pageMarkup`` template at pnglossapi.go:572-654): same form fields,
endpoints, option semantics and result-page structure, re-written from
scratch around this package's server (website.py).

The port's own copy of ``pngloss_tpu/webassets.py``: the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import html

GITHUB = "https://github.com/foobaz/pngloss"


def _head(title: str) -> str:
    return (
        "<!DOCTYPE html>\n<html lang=\"en\">\n<head>\n"
        "<meta charset=\"utf-8\">\n"
        "<meta name=\"description\" content=\"Lossy PNG compression to "
        "shrink your PNG images\"/>\n"
        f"<title>{title}</title>\n"
        "<link rel=\"stylesheet\" type=\"text/css\" href=\"style.css\">\n"
        "</head>\n<body>\n<div class=\"all-page\">\n"
    )


_FOOT = (
    "</div>\n<div class=\"bottom-info address\">"
    f"<a href=\"{GITHUB}\" class=\"gray-link\" target=\"_blank\">pngloss</a>"
    "</div>\n</body>\n</html>\n"
)


def _options_fields(strength: int = 19, bleed: int = 2,
                    strip: int = 0) -> str:
    """The strength / bleed / strip option rows shared by the front page
    and the result page's compress-again form."""
    def radio(name, value, label, checked):
        c = " checked" if checked else ""
        return (f"<label><input type=\"radio\" name=\"{name}\" "
                f"class=\"radio\" value=\"{value}\"{c}>"
                f"<span class=\"r-text\">{label}</span></label>\n")

    out = [
        "<div class=\"option-box\">",
        "<div class=\"option-left\">Quantization Strength:",
        "<div class=\"option-left-small\">(0 - no compression, 85 - max)"
        "</div></div>",
        "<div class=\"option-right\">",
        f"<label><input type=\"number\" name=\"strength\" class=\"radio\" "
        f"value=\"{strength}\" min=\"0\" max=\"85\"></label>",
        "</div></div>",
        "<div class=\"option-box\">",
        "<div class=\"option-left\">Error Propagation:",
        "<div class=\"option-left-small\">(dithering)</div></div>",
        "<div class=\"option-right\">",
        radio("bleed", 32767, "None", bleed == 32767),
        radio("bleed", 2, "Standard", bleed == 2),
        radio("bleed", 1, "Full", bleed == 1),
        "</div></div>",
        "<div class=\"option-box\">",
        "<div class=\"option-left\">Strip Metadata:</div>",
        "<div class=\"option-right\">",
        radio("strip", 1, "Yes", bool(strip)),
        radio("strip", 0, "No", not strip),
        "</div></div>",
    ]
    return "\n".join(out)


def index_page(prefix: str) -> str:
    return (
        _head("pngloss")
        + "<h1 class=\"main-title\">pngloss</h1>\n"
        "<p>Lossy PNG compression to shrink PNG file size by reducing "
        "image quality.</p>\n"
        "<p class=\"margin1 link-box\">"
        "<a href=\"example.html\" class=\"blue-link\" target=\"_blank\">"
        "Show example</a> | "
        f"<a href=\"{GITHUB}\" class=\"blue-link\" target=\"_blank\">"
        "Go to GitHub</a></p>\n"
        f"<form action=\"{prefix}compress.cgi\" method=\"POST\" "
        "enctype=\"multipart/form-data\">\n"
        "<div class=\"option-box first\">"
        "<div class=\"option-left\">Image Choice:</div>"
        "<div class=\"option-right\">"
        "<input type=\"text\" id=\"url\" name=\"url\" "
        "placeholder=\"Type URL\">"
        "<div class=\"option-right-small\">Or choose a file: "
        "<input type=\"file\" id=\"file\" name=\"file\"></div></div>"
        "<div class=\"option-hint\">Limits: Size: 5MB, Resolution: "
        "3000x3000px.</div></div>\n"
        + _options_fields()
        + "\n<input id=\"submit-button\" type=\"submit\" class=\"button\" "
        "value=\"Compress\">\n</form>\n"
        + _FOOT
    )


def example_page() -> str:
    rows = (
        "<tr><th>Original</th><th>pngloss strength 20</th>"
        "<th>strength 40</th></tr>"
        "<tr>"
        "<td><img src=\"david.png\" width=\"180\" height=\"215\" "
        "alt=\"Original\"></td>"
        "<td><img src=\"david-s20.png\" width=\"180\" height=\"215\" "
        "alt=\"Strength 20\"></td>"
        "<td><img src=\"david-s40.png\" width=\"180\" height=\"215\" "
        "alt=\"Strength 40\"></td>"
        "</tr>"
        "<tr><td>18kB</td><td>7kB (36%)</td><td>5kB (23%)</td></tr>"
    )
    return _head("pngloss example") + f"<table>{rows}</table>\n" + _FOOT


def format_size(n: int) -> str:
    """The Go site's size formatting (pnglossapi.go:273-301): divide by
    1000 while the coefficient exceeds 9999."""
    unit = "B"
    for next_unit in ("kB", "MB", "GB"):
        if n <= 9999:
            break
        n //= 1000
        unit = next_unit
    return f"{n}{unit}"


def result_page(prefix: str, *, sum224: str, strength: int, bleed: int,
                strip: int, in_size: int, out_size: int,
                width: int, height: int) -> str:
    """The full POST response page (pageMarkup, pnglossapi.go:572-654):
    a compress-again form pre-filled with the chosen options plus the
    size/percent line and the compressed image itself."""
    pct = 100.0 * out_size / max(in_size, 1)
    esum = html.escape(sum224, quote=True)
    img_src = html.escape(
        f"{prefix}compressed.cgi?sum224={sum224}&strength={strength}"
        f"&bleed={bleed}&strip={strip}", quote=True)
    return (
        _head("pngloss")
        + f"<form action=\"{prefix}compress.cgi\" method=\"POST\" "
        "enctype=\"multipart/form-data\">\n"
        f"<input type=\"hidden\" name=\"sum224\" value=\"{esum}\">\n"
        + _options_fields(strength, bleed, strip)
        + "\n<input id=\"submit-button\" type=\"submit\" class=\"button\" "
        "value=\"Compress Again\"> | "
        f"<a href=\"{prefix}\" class=\"blue-link\">Start Over</a>\n"
        "</form>\n"
        "<p class=\"margin1 link-box\">"
        f"Compressed to {format_size(out_size)}, {pct:.1f}% of original "
        f"{format_size(in_size)}.<br>"
        f"<img width=\"{width}\" height=\"{height}\" src=\"{img_src}\">"
        "</p>\n"
        + _FOOT
    )


STYLE_CSS = """\
body {
  margin: 0;
  font-family: -apple-system, "Segoe UI", Roboto, Helvetica, Arial,
    sans-serif;
  color: #222;
  background: #fafafa;
}
.all-page {
  max-width: 640px;
  margin: 2em auto;
  padding: 1.5em 2em;
  background: #fff;
  border: 1px solid #ddd;
  border-radius: 6px;
}
.main-title { margin-top: 0; }
.margin1 { margin: 1em 0; }
.link-box a { margin: 0 0.25em; }
.blue-link { color: #06c; text-decoration: none; }
.blue-link:hover { text-decoration: underline; }
.gray-link { color: #888; text-decoration: none; }
.option-box {
  display: flex;
  flex-wrap: wrap;
  align-items: baseline;
  padding: 0.8em 0;
  border-top: 1px solid #eee;
}
.option-box.first { border-top: none; }
.option-left { flex: 0 0 14em; font-weight: 600; }
.option-left-small, .option-right-small, .option-hint {
  font-size: 0.85em;
  font-weight: 400;
  color: #777;
  margin-top: 0.3em;
}
.option-right { flex: 1; }
.option-right input[type="text"] { width: 100%; box-sizing: border-box; }
.option-hint { flex-basis: 100%; }
.radio { margin-right: 0.25em; }
.r-text { margin-right: 1.25em; }
.button {
  margin-top: 1em;
  padding: 0.5em 2em;
  font-size: 1em;
  cursor: pointer;
}
table { border-collapse: collapse; }
th, td { padding: 0.4em 0.8em; text-align: center; }
.bottom-info {
  max-width: 640px;
  margin: 0 auto 2em;
  text-align: center;
  font-size: 0.85em;
}
"""

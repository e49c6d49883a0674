"""Image scrapers for the data flywheel (counterpart of
``nans_clip_tpu/flywheel/scrape.py``, the same sources, files and records).

Compact port of reference scripts/scrape_wikimedia.py / scrape_images.py /
scrape_distractors.py: a Wikimedia-Commons API crawler over Song-dynasty
queries writing images + ``metadata.jsonl``, a distractor-pool scraper
(hard negatives: other-dynasty artwork; easy negatives: unrelated
categories — reference scrape_distractors.py:36-60), and the multi-source
``images`` crawler (reference scrape_images.py:161-445): Baidu Images
acjson API, Wikimedia thumbs, the Met Museum and Art Institute of Chicago
open-access APIs (public-domain-only), with byte-signature validation, a
min-size filter, and resume-from-metadata (``original_url`` dedup across
runs — scrape_images.py:455-467). Pure stdlib HTTP with retry + UA
rotation; in zero-egress environments these simply report failure per URL.
Every request goes through :func:`fetch`, so tests replace it.

  python -m nans_clip_tpu_torch.flywheel.scrape wikimedia --out data
  python -m nans_clip_tpu_torch.flywheel.scrape distractors --out data/distractors
  python -m nans_clip_tpu_torch.flywheel.scrape images --out data
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import random
import re
import time
import urllib.parse
import urllib.request

logger = logging.getLogger(__name__)

USER_AGENTS = [
    "Mozilla/5.0 (X11; Linux x86_64) AppleWebKit/537.36 Chrome/120 Safari/537.36",
    "Mozilla/5.0 (Windows NT 10.0; Win64; x64) AppleWebKit/537.36 Chrome/119",
    "Mozilla/5.0 (Macintosh; Intel Mac OS X 13_5) Safari/605.1.15",
]

SONG_QUERIES = [
    "Southern Song dynasty painting", "南宋 绘画", "Song dynasty landscape painting",
    "宋代 山水画", "Song dynasty ceramics", "南宋 瓷器", "Song dynasty calligraphy",
    "宋代 书法", "Southern Song Hangzhou", "西湖 南宋", "Ma Yuan painting",
    "Xia Gui painting", "李嵩 画", "Song dynasty album leaf", "宋 册页",
    "Song dynasty fan painting", "南宋 官窑", "龙泉窑", "Song dynasty woodblock",
    "宋刻本", "Southern Song manuscript",
]

HARD_NEGATIVE_QUERIES = [
    "Ming dynasty painting", "Qing dynasty painting", "Tang dynasty painting",
    "Yuan dynasty painting", "Japanese ukiyo-e", "Korean Joseon painting",
]
EASY_NEGATIVE_QUERIES = [
    "modern photography city", "western oil painting", "abstract art",
]


def fetch(url: str, retries: int = 3, timeout: int = 30) -> bytes:
    last = None
    for attempt in range(retries):
        try:
            req = urllib.request.Request(url, headers={
                "User-Agent": random.choice(USER_AGENTS)})
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.read()
        except Exception as e:
            last = e
            time.sleep(1.5 * (attempt + 1))
    raise RuntimeError(f"fetch failed after {retries} tries: {url}: {last}")


def commons_search(query: str, limit: int = 50) -> list:
    """Wikimedia Commons file search -> [{title, url, descriptionurl}]."""
    api = ("https://commons.wikimedia.org/w/api.php?action=query&format=json"
           "&generator=search&gsrnamespace=6&gsrlimit={}&gsrsearch={}"
           "&prop=imageinfo&iiprop=url|mime&iiurlwidth=1024").format(
        limit, urllib.parse.quote(query))
    data = json.loads(fetch(api))
    out = []
    for page in data.get("query", {}).get("pages", {}).values():
        info = (page.get("imageinfo") or [{}])[0]
        url = info.get("thumburl") or info.get("url")
        if url and info.get("mime", "").startswith("image/"):
            out.append({"title": page.get("title", ""), "url": url})
    return out


def scrape_queries(queries, out_dir: str, per_query: int, category: str,
                   meta_path: str):
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    with open(meta_path, "a", encoding="utf-8") as meta:
        for q in queries:
            try:
                results = commons_search(q, per_query)
            except Exception as e:
                logger.warning("search failed %r: %s", q, e)
                continue
            for item in results:
                try:
                    raw = fetch(item["url"])
                except Exception as e:
                    logger.warning("download failed %s: %s", item["url"], e)
                    continue
                h = hashlib.sha1(raw).hexdigest()[:16]
                fname = f"{h}.jpg"
                with open(os.path.join(out_dir, fname), "wb") as f:
                    f.write(raw)
                meta.write(json.dumps({
                    "filename": fname, "title": item["title"], "query": q,
                    "category": category, "source": item["url"]},
                    ensure_ascii=False) + "\n")
                n += 1
            time.sleep(0.5)
    logger.info("scraped %d images for %s", n, category)
    return n


# --------------------------------------------------------------------------
# Multi-source crawler (reference scrape_images.py): each source function
# yields candidate dicts {url, title, description, categories, source[, era]}
# and the shared download loop validates + dedups + appends metadata.
# --------------------------------------------------------------------------

#: Reference scrape_images.py:42-44 — per-query cap, byte floor.
MIN_IMAGE_BYTES = 20_000

#: Trimmed per-source query lists (the reference's full Baidu list is ~90
#: strings; a representative subset keeps the tool honest without hammering).
BAIDU_QUERIES = [
    "南宋 山水画 博物馆", "马远 踏歌图 高清", "夏圭 溪山清远图",
    "李唐 万壑松风图", "梁楷 泼墨仙人图", "南宋官窑 瓷器 典型器",
    "龙泉青瓷 南宋 典型器", "南宋 建盏 兔毫", "南宋 缂丝 织物",
    "南宋 德寿宫 重建 建筑细节", "宋代 点茶场景 画", "南宋 临安 刊本",
]
MET_QUERIES = [
    "Song dynasty painting", "Song dynasty ceramics",
    "Song dynasty calligraphy", "Chinese landscape painting Song",
    "Hangzhou",
]
ARTIC_QUERIES = [
    "Song dynasty", "Southern Song", "Chinese landscape painting",
    "Chinese ceramics Song",
]


def is_image_data(data: bytes) -> bool:
    """Byte-signature check (reference scrape_images.py:84-89)."""
    return (data[:3] == b"\xff\xd8\xff" or data[:8] == b"\x89PNG\r\n\x1a\n"
            or data[:4] == b"RIFF" or data[:4] == b"GIF8")


def _slug(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)[:30]


def search_baidu(query: str, limit: int):
    """Baidu Images acjson endpoint (scrape_images.py:161-219): paged JSON,
    escaped-quote fixup, hover/middle/thumb URL preference."""
    for page in range(3):
        api = ("https://image.baidu.com/search/acjson?tn=resultjson_com"
               "&ipn=rj&word={q}&queryWord={q}&ie=utf-8&oe=utf-8&istype=2"
               "&pn={pn}&rn=30").format(q=urllib.parse.quote(query),
                                        pn=page * 30)
        data = json.loads(fetch(api).decode("utf-8", "replace")
                          .replace("\\'", "'"))
        for item in data.get("data", []):
            if not isinstance(item, dict):
                continue
            url = (item.get("hoverURL") or item.get("middleURL")
                   or item.get("thumbURL") or item.get("objURL", ""))
            if not url:
                continue
            title = re.sub(r"<[^>]+>", "",
                           item.get("fromPageTitleEnc", "")
                           or item.get("fromPageTitle", ""))
            yield {"url": url, "title": title or query,
                   "description": f"百度图片: {query}",
                   "categories": ["百度图片"], "source": "Baidu Images"}


def search_met(query: str, limit: int):
    """Met open-access API (scrape_images.py:311-380): search ids, then
    per-object lookup; PUBLIC-DOMAIN objects only."""
    base = "https://collectionapi.metmuseum.org/public/collection/v1"
    ids = json.loads(fetch(
        f"{base}/search?q={urllib.parse.quote(query)}&hasImages=true")
    ).get("objectIDs") or []
    for oid in ids[:max(limit, 15)]:
        try:
            obj = json.loads(fetch(f"{base}/objects/{oid}"))
        except Exception:
            continue
        url = obj.get("primaryImage", "")
        if not url or not obj.get("isPublicDomain", False):
            continue
        period = obj.get("period", "") or obj.get("dynasty", "")
        yield {"url": url,
               "title": obj.get("title", "") or obj.get("objectName", ""),
               "description":
                   f"{period} {obj.get('artistDisplayName', '')}".strip(),
               "categories": [obj.get("department", ""), period],
               "source": "The Metropolitan Museum of Art", "era": period}


def search_artic(query: str, limit: int):
    """Art Institute of Chicago API (scrape_images.py:386-445): one search
    call carrying the field list; images assembled as IIIF URLs;
    public-domain only."""
    api = ("https://api.artic.edu/api/v1/artworks/search?q={}&limit={}"
           "&fields=id,title,date_display,artist_display,image_id,"
           "department_title,is_public_domain").format(
        urllib.parse.quote(query), max(limit, 15))
    for item in json.loads(fetch(api)).get("data", []):
        image_id = item.get("image_id")
        if not image_id or not item.get("is_public_domain", False):
            continue
        period = item.get("date_display", "")
        yield {"url": ("https://www.artic.edu/iiif/2/{}/full/843,/0/"
                       "default.jpg").format(image_id),
               "title": item.get("title", ""),
               "description":
                   f"{period} {item.get('artist_display', '')}".strip(),
               "categories": [item.get("department_title", ""), period],
               "source": "Art Institute of Chicago", "era": period}


def search_wiki_thumbs(query: str, limit: int):
    """Wikimedia candidates for the multi-source crawler (thumb URLs to
    dodge 429s — scrape_images.py:272-285)."""
    for item in commons_search(query, min(limit, 10)):
        yield {"url": item["url"],
               "title": item["title"].replace("File:", ""),
               "description": "", "categories": ["Wiki"],
               "source": "Wikimedia Commons"}


IMAGE_SOURCES = (
    ("baidu", BAIDU_QUERIES, search_baidu),
    ("wiki", SONG_QUERIES[:7], search_wiki_thumbs),
    ("met", MET_QUERIES, search_met),
    ("artic", ARTIC_QUERIES, search_artic),
)


def scrape_images(out: str, per_query: int = 8) -> int:
    """The reference's main loop (scrape_images.py:448-495): resume from
    image_metadata.jsonl via original_url, crawl all four sources, validate
    every download by size + byte signature, append-only metadata."""
    img_dir = os.path.join(out, "images")
    meta_path = os.path.join(out, "image_metadata.jsonl")
    os.makedirs(img_dir, exist_ok=True)
    seen, idx = set(), 0
    if os.path.exists(meta_path):
        with open(meta_path, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    try:
                        seen.add(json.loads(line).get("original_url", ""))
                        idx += 1
                    except ValueError:
                        pass
        logger.info("resuming: %d existing records", idx)
    n = 0
    with open(meta_path, "a", encoding="utf-8") as meta:
        for prefix, queries, search in IMAGE_SOURCES:
            for q in queries:
                got = 0
                try:
                    candidates = list(search(q, per_query))
                except Exception as e:
                    logger.warning("%s search failed %r: %s", prefix, q, e)
                    continue
                for c in candidates:
                    if got >= per_query or c["url"] in seen:
                        continue
                    try:
                        raw = fetch(c["url"])
                    except Exception as e:
                        logger.warning("download failed %s: %s", c["url"], e)
                        continue
                    if len(raw) < MIN_IMAGE_BYTES or not is_image_data(raw):
                        continue
                    url = c.pop("url")
                    h = hashlib.md5(url.encode()).hexdigest()[:8]
                    fname = "{}_{:03d}_{}_{}.jpg".format(
                        prefix, idx, _slug(c["title"] or q), h)
                    with open(os.path.join(img_dir, fname), "wb") as f:
                        f.write(raw)
                    meta.write(json.dumps(
                        dict(c, filename=fname, original_url=url),
                        ensure_ascii=False) + "\n")
                    seen.add(url)
                    idx += 1
                    got += 1
                    n += 1
                    time.sleep(0.1)
    logger.info("multi-source crawl: %d new images (total %d)", n, idx)
    return n


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["wikimedia", "distractors", "images"])
    p.add_argument("--out", default="data")
    p.add_argument("--per-query", type=int, default=30)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)

    if args.mode == "wikimedia":
        scrape_queries(SONG_QUERIES, os.path.join(args.out, "images"),
                       args.per_query, "绘画",
                       os.path.join(args.out, "metadata.jsonl"))
    elif args.mode == "images":
        scrape_images(args.out, per_query=args.per_query)
    else:
        scrape_queries(HARD_NEGATIVE_QUERIES, os.path.join(args.out, "hard"),
                       args.per_query, "hard_negative",
                       os.path.join(args.out, "distractors_meta.jsonl"))
        scrape_queries(EASY_NEGATIVE_QUERIES, os.path.join(args.out, "easy"),
                       args.per_query // 2, "easy_negative",
                       os.path.join(args.out, "distractors_meta.jsonl"))


if __name__ == "__main__":
    main()

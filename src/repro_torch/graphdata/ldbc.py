"""LDBC-SNB-style temporal property graph generator (S3G2-flavoured).

Generates downscaled versions of the paper's evaluation graphs (Table 4):
Person / Post / Comment / Forum vertices; follows / likes / created /
hasMember / containerOf / replyOf edges; correlated properties with lifespans
over a 3-year horizon.  Supports the paper's four person-follows-person
degree distributions (Altmann A, Discrete-Weibull DW, Facebook F, Zipf Z) and
both static (S) and dynamic (D) property variants.

Time model: day-granular int32 time-units over ``[0, T)`` with ``T = 1096``
(3 years).  With ``align=n``, every timestamp is snapped to a multiple of
``T/n`` so the bucketised temporal modes are exact (see DESIGN.md §2); the
benchmark workloads use ``align=16``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .loader import GraphBuilder

T_HORIZON = 1096

VTYPES = ("person", "post", "comment", "forum")
ETYPES = ("follows", "likes", "created", "hasMember", "containerOf", "replyOf")

COUNTRIES = [
    "india", "uk", "us", "china", "germany", "france", "brazil", "japan",
    "kenya", "spain", "mexico", "canada", "italy", "australia", "nigeria",
]
COMPANIES = [f"company{i}" for i in range(40)]
N_TAGS = 64
GENDERS = ("m", "f")
LANGS = ("en", "hi", "zh", "es", "de")


@dataclasses.dataclass
class LdbcParams:
    n_persons: int = 1000
    degree_dist: str = "zipf"          # 'altmann' | 'weibull' | 'facebook' | 'zipf'
    dynamic: bool = False              # static (S) vs dynamic (D) properties
    posts_per_person: float = 4.0
    comments_per_person: float = 8.0
    forums_per_person: float = 0.8
    avg_follows: float = 10.2          # paper: 10.2 friends on average
    interests_per_person: float = 4.0  # paper: 23 (downscaled)
    tags_per_message: float = 1.22     # paper: 1.22 tags per comment
    align: int = 16                    # snap times to T/align grid (0 = off)
    seed: int = 0


def _snap(rng_times: np.ndarray, align: int) -> np.ndarray:
    """Snap to the same ceil-width grid that intervals.bucket_edges uses, so
    bucketised temporal modes are exact on generated data."""
    if not align:
        return rng_times.astype(np.int64)
    step = -(-T_HORIZON // align)  # ceil
    return (rng_times // step) * step


def _degree_samples(rng, dist: str, n: int, avg: float) -> np.ndarray:
    """Out-degree samples for person-follows-person under the four dists."""
    if dist == "zipf":
        d = rng.zipf(2.0, size=n)
    elif dist == "facebook":                      # heavy-ish lognormal
        d = np.exp(rng.normal(np.log(avg) - 0.5, 1.0, size=n))
    elif dist == "weibull":                       # discrete Weibull
        d = rng.weibull(0.8, size=n) * avg
    elif dist == "altmann":                       # power law w/ exp cutoff
        d = rng.zipf(1.9, size=n) * np.exp(-rng.exponential(0.2, size=n))
    else:
        raise ValueError(dist)
    d = np.clip(np.round(d * (avg / max(d.mean(), 1e-9))), 0, 20 * avg)
    return d.astype(np.int64)


def generate_ldbc(params: LdbcParams) -> "TemporalGraph":
    rng = np.random.default_rng(params.seed)
    b = GraphBuilder()
    b.lifespan = (0, T_HORIZON)
    tp = {n: b.vertex_type(n) for n in VTYPES}
    te = {n: b.edge_type(n) for n in ETYPES}
    k_name = b.key("name")
    k_country = b.key("country")
    k_gender = b.key("gender")
    k_interest = b.key("hasInterest")
    k_works = b.key("worksAt")
    k_tag = b.key("tag")
    k_lang = b.key("language")
    k_len = b.key("length", ordered=True)

    N = params.n_persons
    align = params.align

    def birth(n, late=0.9):
        return _snap(rng.integers(0, int(T_HORIZON * late), size=n), align)

    # ---------------------------------------------------------------- persons
    p_start = birth(N)
    person_ids = [b.add_vertex(tp["person"], (int(s), T_HORIZON)) for s in p_start]
    tag_pop = rng.zipf(1.6, size=4 * N) % N_TAGS  # zipf-popular tag pool
    for i, vid in enumerate(person_ids):
        b.set_vprop(vid, k_name, f"p{i}")
        b.set_vprop(vid, k_gender, GENDERS[int(rng.integers(2))])
        s = int(p_start[i])
        if params.dynamic:
            # country + worksAt change over time (the paper's dynamic props)
            n_seg = int(rng.integers(1, 4))
            cuts = np.sort(_snap(rng.integers(s, T_HORIZON, size=n_seg - 1), align)) \
                if n_seg > 1 else np.asarray([], np.int64)
            bounds = [s, *[int(c) for c in cuts], T_HORIZON]
            bounds = sorted(set(bounds))
            n_seg_eff = len(bounds) - 1
            # sample without replacement so each (key, value) pair is valid
            # for a single contiguous window — the engine's interval-mode
            # envelope (DESIGN.md §2) and the natural "moved country" shape.
            cs = rng.choice(len(COUNTRIES), size=n_seg_eff, replace=False)
            ws = rng.choice(len(COMPANIES), size=n_seg_eff, replace=False)
            for j in range(n_seg_eff):
                if bounds[j] < bounds[j + 1]:
                    b.set_vprop(vid, k_country, COUNTRIES[int(cs[j])],
                                (bounds[j], bounds[j + 1]))
                    b.set_vprop(vid, k_works, COMPANIES[int(ws[j])],
                                (bounds[j], bounds[j + 1]))
        else:
            b.set_vprop(vid, k_country, COUNTRIES[int(rng.integers(len(COUNTRIES)))])
            b.set_vprop(vid, k_works, COMPANIES[int(rng.integers(len(COMPANIES)))])
        n_int = max(1, int(rng.poisson(params.interests_per_person)))
        ints = np.unique(rng.choice(tag_pop, size=n_int))
        for t in ints:
            if params.dynamic:
                ts = int(_snap(rng.integers(s, T_HORIZON), align))
                b.set_vprop(vid, k_interest, f"tag{t}", (min(ts, T_HORIZON - 1), T_HORIZON))
            else:
                b.set_vprop(vid, k_interest, f"tag{t}")

    # ---------------------------------------------------------------- follows
    deg = _degree_samples(rng, params.degree_dist, N, params.avg_follows)
    src = np.repeat(np.arange(N), deg)
    dst = rng.integers(0, N, size=src.shape[0])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    for s_, d_ in zip(src, dst):
        lo = max(int(p_start[s_]), int(p_start[d_]))
        st = int(_snap(rng.integers(lo, T_HORIZON), align))
        st = min(st, T_HORIZON - 1)
        # some follows end (unfollow) — makes ETR queries non-trivial
        if rng.random() < 0.35:
            step = -(-T_HORIZON // align) if align else 1
            en = int(_snap(rng.integers(st + 1, T_HORIZON + 1), align))
            if en <= st:  # keep grid-aligned when pushing past start
                en = st + step
            en = min(en, T_HORIZON)
        else:
            en = T_HORIZON
        b.add_edge(int(person_ids[s_]), int(person_ids[d_]), te["follows"], (st, en))

    # ------------------------------------------------------------------ forums
    n_forums = int(params.forums_per_person * N)
    f_start = birth(n_forums)
    forum_ids = [b.add_vertex(tp["forum"], (int(s), T_HORIZON)) for s in f_start]
    forum_tags = rng.choice(tag_pop, size=n_forums)
    for i, vid in enumerate(forum_ids):
        b.set_vprop(vid, k_tag, f"tag{forum_tags[i]}")
    # membership: each person joins ~3 forums
    for i, pid in enumerate(person_ids):
        for f in rng.integers(0, max(n_forums, 1), size=int(rng.poisson(3.0))):
            lo = max(int(p_start[i]), int(f_start[f]))
            st = min(int(_snap(rng.integers(lo, T_HORIZON), align)), T_HORIZON - 1)
            b.add_edge(int(forum_ids[f]), int(pid), te["hasMember"], (st, T_HORIZON))

    # ------------------------------------------------------------------- posts
    n_posts = int(params.posts_per_person * N)
    creators = rng.integers(0, N, size=n_posts)
    post_forum = rng.integers(0, max(n_forums, 1), size=n_posts)
    post_ids = []
    for i in range(n_posts):
        lo = max(int(p_start[creators[i]]), int(f_start[post_forum[i]]) if n_forums else 0)
        st = min(int(_snap(rng.integers(lo, T_HORIZON), align)), T_HORIZON - 1)
        vid = b.add_vertex(tp["post"], (st, T_HORIZON))
        post_ids.append(vid)
        for t in np.unique(rng.choice(tag_pop, size=max(1, int(rng.poisson(params.tags_per_message))))):
            b.set_vprop(vid, k_tag, f"tag{t}")
        b.set_vprop(vid, k_lang, LANGS[int(rng.integers(len(LANGS)))])
        b.set_vprop(vid, k_len, int(rng.integers(1, 500)))
        b.add_edge(int(person_ids[creators[i]]), vid, te["created"], (st, T_HORIZON))
        if n_forums:
            b.add_edge(int(forum_ids[post_forum[i]]), vid, te["containerOf"], (st, T_HORIZON))

    # ----------------------------------------------------------------- comments
    n_comments = int(params.comments_per_person * N)
    c_creators = rng.integers(0, N, size=n_comments)
    c_parents = rng.integers(0, max(n_posts, 1), size=n_comments)
    for i in range(n_comments):
        parent = post_ids[c_parents[i]] if n_posts else person_ids[0]
        parent_start = int(b._v_lives[parent][0])
        lo = max(int(p_start[c_creators[i]]), parent_start)
        st = min(int(_snap(rng.integers(lo, T_HORIZON), align)), T_HORIZON - 1)
        vid = b.add_vertex(tp["comment"], (st, T_HORIZON))
        for t in np.unique(rng.choice(tag_pop, size=max(1, int(rng.poisson(params.tags_per_message))))):
            b.set_vprop(vid, k_tag, f"tag{t}")
        b.set_vprop(vid, k_len, int(rng.integers(1, 200)))
        b.add_edge(int(person_ids[c_creators[i]]), vid, te["created"], (st, T_HORIZON))
        if n_posts:
            b.add_edge(vid, parent, te["replyOf"], (st, T_HORIZON))

    # ------------------------------------------------------------------- likes
    n_likes = int(2.0 * N)
    l_p = rng.integers(0, N, size=n_likes)
    l_m = rng.integers(0, max(n_posts, 1), size=n_likes)
    for i in range(n_likes):
        if not n_posts:
            break
        post = post_ids[l_m[i]]
        lo = max(int(p_start[l_p[i]]), int(b._v_lives[post][0]))
        st = min(int(_snap(rng.integers(lo, T_HORIZON), align)), T_HORIZON - 1)
        b.add_edge(int(person_ids[l_p[i]]), post, te["likes"], (st, T_HORIZON))

    g = b.build()
    g.meta["params"] = dataclasses.asdict(params)
    g.meta["builder"] = b  # keep dictionaries for query rewriting
    return g


def graph_name(params: LdbcParams) -> str:
    tag = {"altmann": "A", "weibull": "DW", "facebook": "F", "zipf": "Z"}[params.degree_dist]
    sd = "D" if params.dynamic else "S"
    return f"{params.n_persons}:{tag}-{sd}"

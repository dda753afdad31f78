"""LDBC-SNB-style temporal property graph, generated with NumPy in bulk.

A frozen, vectorised copy of the distributions of the port's
``graphdata/ldbc.generate_ldbc`` (S3G2-flavoured): Person / Post / Comment /
Forum vertices, follows / likes / created / hasMember / containerOf /
replyOf edges, and correlated properties with lifespans over a three-year
horizon of day-granular time units ``[0, T)``.  The draws are the same
distributions with the same parameters, made array by array instead of
vertex by vertex, so one seed gives one graph here but not the graph the
port's generator gives for it.

Layout: vertices are type-major (persons, posts, comments, forums: type ids
0-3), so each type is a contiguous id range.  Property values are integer
ids: an unordered key's ids index its value list below (tags and interests
both by tag number, so ``hasInterest == tag`` compares the same tag), and the
ordered keys ``length`` (of a message) and ``birthday`` (of a person, a day
number) are their own values.  Every timestamp is snapped to the
``T / align`` grid.

The result is plain arrays (``GraphData``); ``pivot`` turns a flat property
table into the dense [entities, slots] columns both the program and the
reference read.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

T_HORIZON = 1096

VTYPES = ("person", "post", "comment", "forum")
ETYPES = ("follows", "likes", "created", "hasMember", "containerOf", "replyOf")
KEYS = ("name", "country", "gender", "hasInterest", "worksAt", "tag",
        "language", "length", "birthday")
ORDERED_KEYS = ("length", "birthday")
#: birthdays are day numbers over ten years (LDBC Datagen: 1980-1989)
BIRTHDAY_DAYS = 3653

COUNTRIES = ("india", "uk", "us", "china", "germany", "france", "brazil",
             "japan", "kenya", "spain", "mexico", "canada", "italy",
             "australia", "nigeria")
N_COMPANIES = 40
N_TAGS = 64
GENDERS = ("m", "f")
LANGS = ("en", "hi", "zh", "es", "de")

#: value id of a named value, for the keys queries name values of
VALUE_IDS = {
    "gender": {g: i for i, g in enumerate(GENDERS)},
    "language": {s: i for i, s in enumerate(LANGS)},
    "country": {c: i for i, c in enumerate(COUNTRIES)},
}


@dataclasses.dataclass(frozen=True)
class LdbcParams:
    """The generator's parameters (keys of a configuration file)."""
    n_persons: int = 1000
    degree_dist: str = "zipf"        # 'altmann' | 'weibull' | 'facebook' | 'zipf'
    dynamic: bool = False            # static (S) or dynamic (D) properties
    posts_per_person: float = 4.0
    comments_per_person: float = 8.0
    forums_per_person: float = 0.8
    avg_follows: float = 10.2
    interests_per_person: float = 4.0
    tags_per_message: float = 1.22
    likes_per_person: float = 2.0
    memberships_per_person: float = 3.0
    unfollow_share: float = 0.35
    align: int = 16


def params_of(config: Dict) -> LdbcParams:
    """The generator's parameters among a configuration file's keys."""
    names = {f.name for f in dataclasses.fields(LdbcParams)}
    return LdbcParams(**{k: v for k, v in config.items() if k in names})


@dataclasses.dataclass
class GraphData:
    """One generated graph as plain arrays (int32 unless noted)."""
    params: LdbcParams
    v_type: np.ndarray               # [V]
    v_life: np.ndarray               # [V, 2]
    e_src: np.ndarray                # [E]
    e_dst: np.ndarray                # [E]
    e_type: np.ndarray               # [E]
    e_life: np.ndarray               # [E, 2]
    #: key id -> (vals [V, S], life [V, S, 2]); missing slots hold -1 / (0, 0)
    vprops: Dict[int, Tuple[np.ndarray, np.ndarray]]
    type_ranges: Dict[str, Tuple[int, int]]
    lifespan: Tuple[int, int] = (0, T_HORIZON)

    @property
    def n_vertices(self) -> int:
        return int(self.v_type.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.e_src.shape[0])

    def vtype_id(self, name: str) -> int:
        return VTYPES.index(name)

    def etype_id(self, name: str) -> int:
        return ETYPES.index(name)

    def key_id(self, name: str) -> int:
        return KEYS.index(name)


def _step(align: int) -> int:
    return -(-T_HORIZON // align) if align else 1


def _snap(t: np.ndarray, align: int) -> np.ndarray:
    t = np.asarray(t, np.int64)
    if not align:
        return t
    step = _step(align)
    return (t // step) * step


def _after(rng, lo: np.ndarray, align: int) -> np.ndarray:
    """A snapped time in [lo, T), capped at T - 1 (an edge or message start)."""
    return np.minimum(_snap(rng.integers(lo, T_HORIZON), align), T_HORIZON - 1)


def degree_samples(rng, dist: str, n: int, avg: float) -> np.ndarray:
    """Out-degrees of person-follows-person under the four distributions."""
    if dist == "zipf":
        d = rng.zipf(2.0, size=n)
    elif dist == "facebook":                      # heavy-ish lognormal
        d = np.exp(rng.normal(np.log(avg) - 0.5, 1.0, size=n))
    elif dist == "weibull":                       # discrete Weibull
        d = rng.weibull(0.8, size=n) * avg
    elif dist == "altmann":                       # power law with a cut-off
        d = rng.zipf(1.9, size=n) * np.exp(-rng.exponential(0.2, size=n))
    else:
        raise ValueError(f"unknown degree distribution {dist!r}")
    d = np.clip(np.round(d * (avg / max(d.mean(), 1e-9))), 0, 20 * avg)
    return d.astype(np.int64)


def _unique_rows(owner: np.ndarray, value: np.ndarray, n_values: int):
    """Distinct (owner, value) pairs, sorted by owner then value."""
    key = np.unique(owner.astype(np.int64) * n_values + value)
    return key // n_values, key % n_values


def _draw_tags(rng, tag_pop: np.ndarray, n_owners: int, mean: float):
    """Each owner gets the distinct tags of max(1, Poisson(mean)) draws."""
    n = np.maximum(1, rng.poisson(mean, size=n_owners))
    owner = np.repeat(np.arange(n_owners), n)
    tags = tag_pop[rng.integers(0, tag_pop.shape[0], size=owner.shape[0])]
    return _unique_rows(owner, tags, N_TAGS)


def pivot(n_entities: int, ent: np.ndarray, val: np.ndarray, lo: np.ndarray,
          hi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Flat (entity, value, [lo, hi)) rows to dense (vals [N, S], life [N, S, 2]).

    Slots keep the rows' order within an entity; an entity with fewer rows
    than ``S`` has -1 values and (0, 0) lifespans in its last slots."""
    ent = np.asarray(ent, np.int64)
    order = np.argsort(ent, kind="stable")
    ent = ent[order]
    counts = np.bincount(ent, minlength=n_entities)
    S = max(1, int(counts.max(initial=1)))
    first = np.concatenate(([0], np.cumsum(counts)))[ent]
    slot = np.arange(ent.shape[0]) - first
    vals = np.full((n_entities, S), -1, np.int32)
    life = np.zeros((n_entities, S, 2), np.int32)
    vals[ent, slot] = np.asarray(val)[order]
    life[ent, slot, 0] = np.asarray(lo)[order]
    life[ent, slot, 1] = np.asarray(hi)[order]
    return vals, life


def generate(p: LdbcParams, rng: np.random.Generator) -> GraphData:
    """The graph of ``p``, drawn from ``rng``."""
    T, a, N = T_HORIZON, p.align, p.n_persons
    step = _step(a)
    # ---------------------------------------------------------------- persons
    p_start = _snap(rng.integers(0, int(T * 0.9), size=N), a)
    tag_pop = rng.zipf(1.6, size=4 * N) % N_TAGS          # zipf-popular tags
    gender = rng.integers(0, 2, size=N)
    birthday = rng.integers(0, BIRTHDAY_DAYS, size=N)
    pid = np.arange(N)
    if p.dynamic:
        # country and worksAt change over time: 1-3 segments a person, each
        # (key, value) pair valid for one contiguous window
        n_seg = rng.integers(1, 4, size=N)
        cuts = _snap(rng.integers(p_start[:, None], T, size=(N, 2)), a)
        cuts = np.where(np.arange(2)[None, :] < (n_seg - 1)[:, None], cuts, T)
        b = np.sort(np.concatenate([p_start[:, None], cuts,
                                    np.full((N, 1), T)], axis=1), axis=1)
        keep = np.concatenate([np.ones((N, 1), bool), b[:, 1:] != b[:, :-1]], axis=1)
        # segment j of a person runs between its j-th and (j+1)-th distinct bound
        nb = keep.sum(axis=1)
        bounds = np.full((N, 4), T, np.int64)
        rows, cols = np.nonzero(keep)
        bounds[rows, np.cumsum(keep, axis=1)[rows, cols] - 1] = b[rows, cols]
        n_eff = nb - 1
        cs = np.argsort(rng.random((N, len(COUNTRIES))), axis=1)[:, :3]
        ws = np.argsort(rng.random((N, N_COMPANIES)), axis=1)[:, :3]
        seg_p, seg_j = np.nonzero(np.arange(3)[None, :] < n_eff[:, None])
        seg_lo, seg_hi = bounds[seg_p, seg_j], bounds[seg_p, seg_j + 1]
        country = (seg_p, cs[seg_p, seg_j], seg_lo, seg_hi)
        works = (seg_p, ws[seg_p, seg_j], seg_lo, seg_hi)
    else:
        full = (pid, np.full(N, T))
        country = (pid, rng.integers(0, len(COUNTRIES), size=N), p_start, full[1])
        works = (pid, rng.integers(0, N_COMPANIES, size=N), p_start, full[1])
    int_p, int_t = _draw_tags(rng, tag_pop, N, p.interests_per_person)
    if p.dynamic:
        ts = _snap(rng.integers(p_start[int_p], T), a)
        interest = (int_p, int_t, np.minimum(ts, T - 1), np.full(int_p.shape, T))
    else:
        interest = (int_p, int_t, p_start[int_p], np.full(int_p.shape, T))

    # ---------------------------------------------------------------- follows
    deg = degree_samples(rng, p.degree_dist, N, p.avg_follows)
    f_src = np.repeat(pid, deg)
    f_dst = rng.integers(0, N, size=f_src.shape[0])
    keep = f_src != f_dst
    f_src, f_dst = f_src[keep], f_dst[keep]
    f_st = _after(rng, np.maximum(p_start[f_src], p_start[f_dst]), a)
    unfollow = rng.random(f_src.shape[0]) < p.unfollow_share
    f_en = _snap(rng.integers(f_st + 1, T + 1), a)
    f_en = np.minimum(np.where(f_en <= f_st, f_st + step, f_en), T)
    f_en = np.where(unfollow, f_en, T)

    # ----------------------------------------------------------------- forums
    n_forums = int(p.forums_per_person * N)
    fo_start = _snap(rng.integers(0, int(T * 0.9), size=n_forums), a)
    fo_tag = tag_pop[rng.integers(0, tag_pop.shape[0], size=n_forums)]
    n_mem = rng.poisson(p.memberships_per_person, size=N)
    m_person = np.repeat(pid, n_mem)
    m_forum = rng.integers(0, max(n_forums, 1), size=m_person.shape[0])
    m_st = _after(rng, np.maximum(p_start[m_person], fo_start[m_forum]), a)

    # ------------------------------------------------------------------ posts
    n_posts = int(p.posts_per_person * N)
    po_creator = rng.integers(0, N, size=n_posts)
    po_forum = rng.integers(0, max(n_forums, 1), size=n_posts)
    po_start = _after(rng, np.maximum(p_start[po_creator], fo_start[po_forum]), a)
    po_tag_o, po_tag_t = _draw_tags(rng, tag_pop, n_posts, p.tags_per_message)
    po_lang = rng.integers(0, len(LANGS), size=n_posts)
    po_len = rng.integers(1, 500, size=n_posts)

    # --------------------------------------------------------------- comments
    n_comments = int(p.comments_per_person * N)
    c_creator = rng.integers(0, N, size=n_comments)
    c_parent = rng.integers(0, max(n_posts, 1), size=n_comments)
    c_start = _after(rng, np.maximum(p_start[c_creator], po_start[c_parent]), a)
    c_tag_o, c_tag_t = _draw_tags(rng, tag_pop, n_comments, p.tags_per_message)
    c_len = rng.integers(1, 200, size=n_comments)

    # ------------------------------------------------------------------ likes
    n_likes = int(p.likes_per_person * N)
    l_person = rng.integers(0, N, size=n_likes)
    l_post = rng.integers(0, max(n_posts, 1), size=n_likes)
    l_st = _after(rng, np.maximum(p_start[l_person], po_start[l_post]), a)

    # ---------------------------------------------------------- type-major ids
    o_post = N
    o_comment = o_post + n_posts
    o_forum = o_comment + n_comments
    V = o_forum + n_forums
    v_type = np.concatenate([np.full(N, 0), np.full(n_posts, 1),
                             np.full(n_comments, 2), np.full(n_forums, 3)])
    v_start = np.concatenate([p_start, po_start, c_start, fo_start])
    v_life = np.stack([v_start, np.full(V, T)], axis=1)

    et = {n: i for i, n in enumerate(ETYPES)}
    parts = [  # (src, dst, type, start, end)
        (f_src, f_dst, et["follows"], f_st, f_en),
        (o_forum + m_forum, m_person, et["hasMember"], m_st, T),
        (po_creator, o_post + np.arange(n_posts), et["created"], po_start, T),
        (o_forum + po_forum, o_post + np.arange(n_posts), et["containerOf"], po_start, T),
        (c_creator, o_comment + np.arange(n_comments), et["created"], c_start, T),
        (o_comment + np.arange(n_comments), o_post + c_parent, et["replyOf"], c_start, T),
        (l_person, o_post + l_post, et["likes"], l_st, T),
    ]
    e_src = np.concatenate([x[0] for x in parts])
    e_dst = np.concatenate([x[1] for x in parts])
    e_type = np.concatenate([np.full(x[0].shape[0], x[2]) for x in parts])
    e_life = np.stack([np.concatenate([np.broadcast_to(x[k], x[0].shape) for x in parts])
                       for k in (3, 4)], axis=1)
    if n_forums == 0:   # no forum to join or post in: drop those edges
        ok = ~np.isin(e_type, [et["hasMember"], et["containerOf"]])
        e_src, e_dst, e_type, e_life = e_src[ok], e_dst[ok], e_type[ok], e_life[ok]

    # ------------------------------------------------------------- properties
    k = {n: i for i, n in enumerate(KEYS)}
    life_of = v_start
    rows = {
        k["name"]: (pid, pid, p_start, np.full(N, T)),
        k["country"]: country,
        k["gender"]: (pid, gender, p_start, np.full(N, T)),
        k["birthday"]: (pid, birthday, p_start, np.full(N, T)),
        k["hasInterest"]: interest,
        k["worksAt"]: works,
        k["tag"]: (np.concatenate([o_post + po_tag_o, o_comment + c_tag_o,
                                   o_forum + np.arange(n_forums)]),
                   np.concatenate([po_tag_t, c_tag_t, fo_tag]), None, None),
        k["language"]: (o_post + np.arange(n_posts), po_lang, None, None),
        k["length"]: (np.concatenate([o_post + np.arange(n_posts),
                                      o_comment + np.arange(n_comments)]),
                      np.concatenate([po_len, c_len]), None, None),
    }
    vprops = {}
    for key, (ent, val, lo, hi) in rows.items():
        if lo is None:      # valid over the entity's whole lifespan
            lo, hi = life_of[ent], np.full(ent.shape, T)
        vprops[key] = pivot(V, ent, val, lo, hi)

    i32 = lambda x: np.ascontiguousarray(x, np.int32)  # noqa: E731
    return GraphData(
        params=p, v_type=i32(v_type), v_life=i32(v_life), e_src=i32(e_src),
        e_dst=i32(e_dst), e_type=i32(e_type), e_life=i32(e_life),
        vprops={key: (i32(v), i32(l)) for key, (v, l) in vprops.items()},
        type_ranges=dict(person=(0, N), post=(o_post, o_comment),
                         comment=(o_comment, o_forum), forum=(o_forum, V)))

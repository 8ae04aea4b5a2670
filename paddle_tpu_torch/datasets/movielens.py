"""MovieLens ml-1m reader creators (parity: paddle/dataset/movielens.py —
train/test yield [user_id, gender, age_bucket, job, movie_id, category_ids,
title_word_ids, [rating]]; plus the meta helpers the recommender book test
uses: max_user_id, max_movie_id, max_job_id, movie_categories,
get_movie_title_dict, user_info, movie_info)."""

import os
import re
import zipfile

import numpy as np

from . import common

age_table = [1, 18, 25, 35, 45, 50, 56]

_TITLE_RE = re.compile(r"^(.*)\((\d+)\)$")


class MovieInfo:
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        return [self.index,
                [_META["categories"][c] for c in self.categories],
                [_META["title_dict"][w.lower()] for w in self.title.split()]]

    def __repr__(self):
        return "<MovieInfo id(%d), title(%s), categories(%s)>" % (
            self.index, self.title, self.categories)


class UserInfo:
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]

    def __repr__(self):
        return "<UserInfo id(%d), gender(%s), age(%d), job(%d)>" % (
            self.index, "M" if self.is_male else "F",
            age_table[self.age], self.job_id)


_META = None


def _load_meta():
    """Parse ml-1m movies/users from the zip, or build the synthetic world."""
    global _META
    if _META is not None:
        return _META
    meta = {"movies": {}, "users": {}, "categories": {}, "title_dict": {},
            "synthetic": False}
    path = common.cache_path("movielens", "ml-1m.zip")
    if os.path.exists(path):
        with zipfile.ZipFile(path) as z:
            title_words, cats = set(), set()
            with z.open("ml-1m/movies.dat") as f:
                for line in f:
                    mid, title, categories = (
                        line.decode("latin1").strip().split("::"))
                    categories = categories.split("|")
                    cats.update(categories)
                    m = _TITLE_RE.match(title)
                    title = m.group(1) if m else title
                    meta["movies"][int(mid)] = MovieInfo(mid, categories,
                                                         title)
                    title_words.update(w.lower() for w in title.split())
            meta["categories"] = {c: i for i, c in enumerate(sorted(cats))}
            meta["title_dict"] = {w: i for i, w in
                                  enumerate(sorted(title_words))}
            with z.open("ml-1m/users.dat") as f:
                for line in f:
                    uid, gender, age, job, _zip = (
                        line.decode("latin1").strip().split("::"))
                    meta["users"][int(uid)] = UserInfo(uid, gender, age, job)
    else:
        common.warn_synthetic("movielens")
        meta["synthetic"] = True
        rng = np.random.RandomState(42)
        cats = ["Action", "Comedy", "Drama", "Horror", "Romance", "Sci-Fi"]
        meta["categories"] = {c: i for i, c in enumerate(cats)}
        words = ["movie%d" % i for i in range(120)]
        meta["title_dict"] = {w: i for i, w in enumerate(words)}
        for mid in range(1, 201):
            ncat = int(rng.randint(1, 3))
            title = " ".join(rng.choice(words, size=int(rng.randint(1, 4))))
            meta["movies"][mid] = MovieInfo(
                mid, list(rng.choice(cats, size=ncat, replace=False)), title)
        for uid in range(1, 301):
            meta["users"][uid] = UserInfo(
                uid, "M" if rng.rand() < 0.5 else "F",
                age_table[int(rng.randint(0, len(age_table)))],
                int(rng.randint(0, 21)))
    _META = meta
    return meta


def _ratings():
    meta = _load_meta()
    path = common.cache_path("movielens", "ml-1m.zip")
    if not meta["synthetic"] and os.path.exists(path):
        with zipfile.ZipFile(path) as z:
            with z.open("ml-1m/ratings.dat") as f:
                for line in f:
                    uid, mid, rating, _ts = (
                        line.decode("latin1").strip().split("::"))
                    yield int(uid), int(mid), float(rating)
    else:
        rng = np.random.RandomState(7)
        uids = sorted(meta["users"])
        mids = sorted(meta["movies"])
        for _ in range(4000):
            uid = int(rng.choice(uids))
            mid = int(rng.choice(mids))
            # users like the category (uid % ncats): learnable signal
            liked = meta["categories"][meta["movies"][mid].categories[0]] == (
                uid % len(meta["categories"]))
            rating = 4 + rng.randint(0, 2) if liked else 1 + rng.randint(0, 3)
            yield uid, mid, float(rating)


def _reader(rand_seed=0, test_ratio=0.1, is_test=False):
    meta = _load_meta()
    rng = np.random.RandomState(rand_seed)
    for uid, mid, rating in _ratings():
        if (rng.rand() < test_ratio) == is_test:
            usr, mov = meta["users"][uid], meta["movies"][mid]
            yield usr.value() + mov.value() + [[rating * 2 - 5.0]]


def train():
    return lambda: _reader(is_test=False)


def test():
    return lambda: _reader(is_test=True)


def get_movie_title_dict():
    return _load_meta()["title_dict"]


def max_movie_id():
    return max(_load_meta()["movies"])


def max_user_id():
    return max(_load_meta()["users"])


def max_job_id():
    return max(u.job_id for u in _load_meta()["users"].values())


def movie_categories():
    return _load_meta()["categories"]


def user_info():
    return _load_meta()["users"]


def movie_info():
    return _load_meta()["movies"]

"""The port's offline pipeline (``data_prep/``) against the JAX package's,
stage by stage on the same small inputs (the seeded raw corpus of
``data_prep/synthetic.py`` and label tables made here): JSON and text
outputs byte-equal, returned values equal, label frames and parquet
tables equal (pandas is here; the port imports it only inside the
functions that need it). The image fetcher is a stub: the real one reaches
the network. The ``run`` CLI's sub-commands likewise, and its ``splits``
without pandas (``duped.json``)."""

import json
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from multimodaldiscussiontransformer_tpu.data_prep import gather as jgather
from multimodaldiscussiontransformer_tpu.data_prep import images as jimages
from multimodaldiscussiontransformer_tpu.data_prep import labels as jlabels
from multimodaldiscussiontransformer_tpu.data_prep import run as jrun
from multimodaldiscussiontransformer_tpu.data_prep import splits as jsplits
from multimodaldiscussiontransformer_tpu.data_prep import text_export as jexport
from multimodaldiscussiontransformer_tpu.data_prep import trees as jtrees
from multimodaldiscussiontransformer_tpu_torch.data_prep import gather as pgather
from multimodaldiscussiontransformer_tpu_torch.data_prep import images as pimages
from multimodaldiscussiontransformer_tpu_torch.data_prep import labels as plabels
from multimodaldiscussiontransformer_tpu_torch.data_prep import run as prun
from multimodaldiscussiontransformer_tpu_torch.data_prep import splits as psplits
from multimodaldiscussiontransformer_tpu_torch.data_prep import text_export as pexport
from multimodaldiscussiontransformer_tpu_torch.data_prep import trees as ptrees
from multimodaldiscussiontransformer_tpu_torch.data_prep.synthetic import synthetic_raw_corpus

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    d = tmp_path_factory.mktemp("raw")
    synthetic_raw_corpus(str(d / "raw.json"), str(d), num_trees=24, comments=(3, 20), big_trees=1,
                         big_comments=(40, 60), image_prob=0.0, seed=4)
    return d / "raw.json"


def _both(tmp_path, fn_p, fn_j, *args, **kw):
    """Run the port's and JAX's stage into their own directories; their
    return values."""
    outs = []
    for name, fn in (("port", fn_p), ("jax", fn_j)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        fill = lambda a: a.format(d=d) if isinstance(a, str) else a  # noqa: E731
        outs.append(fn(*map(fill, args), **{k: fill(v) for k, v in kw.items()}))
    return outs


def _same_tree(a, b):
    """Every file under the two directories byte-equal (parquet: as frames)."""
    files = sorted(os.path.relpath(os.path.join(r, f), a) for r, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), b) for r, _, fs in os.walk(b) for f in fs)
    for f in files:
        if f.endswith(".parquet"):
            pd.testing.assert_frame_equal(pd.read_parquet(os.path.join(a, f)), pd.read_parquet(os.path.join(b, f)))
        else:
            with open(os.path.join(a, f), "rb") as x, open(os.path.join(b, f), "rb") as y:
                assert x.read() == y.read(), f
    return files


def test_labels_match_jax(tmp_path):
    cad = tmp_path / "cad.tsv"
    pd.DataFrame({
        "split": ["train", "test", "dev", "exclude", "train", "train"],
        "info_id.link": ["l1", "l2", "l3", "l4", "l1", "l5"],
        "info_id": ["a-post", "b-title", "c", "d", "a-post", "e"],
        "annotation_Primary": ["Neutral", "DEG", "Neutral", "DEG", "IdentityDirectedAbuse", "Neutral"],
    }).to_csv(cad, sep="\t", index=False)
    slurs = tmp_path / "slurs.csv"
    pd.DataFrame({"id": ["t1_x", "t1_y"], "link_id": ["t3_p", "t3_q"], "gold_label": ["DEG", "NDG"],
                  "extra": [1, 2]}).to_csv(slurs, index=False)
    lti = tmp_path / "lti.csv"
    pd.DataFrame({"id": ["1. \tabc\n2. \tdef\n", "1. \tghi\n"], "hate_speech_idx": ["[2]", "n/a"]}).to_csv(lti, index=False)
    lookup = lambda ids: {i: f"t3_{i}x" for i in ids if i != "def"}  # noqa: E731
    for fn, src, kw in (("process_cad", cad, {}), ("process_slurs", slurs, {}), ("process_lti", lti, {}),
                        ("process_lti", lti, {"link_id_lookup": lookup})):
        got, want = _both(tmp_path, getattr(plabels, fn), getattr(jlabels, fn), str(src), "{d}/out.parquet", **kw)
        pd.testing.assert_frame_equal(got, want)
        _same_tree(tmp_path / "port", tmp_path / "jax")
    for votes in (["Neutral"], ["DEG", "Neutral", "Neutral"], ["DEG", "HOM", "HOM"]):
        assert plabels.cad_majority_label(votes) == jlabels.cad_majority_label(votes)
    assert plabels.explode_lti_ids("\n1. \tabc\n2. \tdef\n") == jlabels.explode_lti_ids("\n1. \tabc\n2. \tdef\n")


def test_gather_matches_jax(tmp_path):
    (tmp_path / "RS").write_text('{"id":"abc","title":"t"}\n{"id":"zzz","title":"x"}\n{"id":"q9","title":"y"}\n')
    (tmp_path / "RC").write_text('{"id":"c1","link_id":"t3_abc"}\n{"id":"c2","link_id":"t3_zzz"}\n'
                                 '{"id":"c3","link_id":"t3_q9"}')
    got, want = _both(tmp_path, pgather.filter_month_dump, jgather.filter_month_dump, str(tmp_path / "RS"),
                      str(tmp_path / "RC"), ["abc", "q9"], "{d}/subs.json", "{d}/com.json")
    assert got == want == (2, 2)
    _same_tree(tmp_path / "port", tmp_path / "jax")
    pd.DataFrame({"id": ["c1", "c3", "c9"], "label": ["DEG", "NDG", "HOM"]}).to_parquet(tmp_path / "lab-processed.parquet")
    times = {"c1": (1420070400, "t3_abc"), "c3": (1425168000, "t3_q9")}
    lookup = pgather.pushshift_comment_times(lambda ids: {i: times[i] for i in ids if i in times})
    dumps = lambda date: (str(tmp_path / "RS"), str(tmp_path / "RC"))  # noqa: E731
    got, want = _both(tmp_path, pgather.gather, jgather.gather, str(tmp_path / "lab-processed.parquet"), "{d}/work",
                      lookup, dumps)
    pd.testing.assert_frame_equal(got, want)
    _same_tree(tmp_path / "port", tmp_path / "jax")
    assert pgather.formatted_month(1420070400.0) == jgather.formatted_month(1420070400.0)
    assert pgather.pushshift_comment_times(lambda ids: {i: 1 for i in ids})(list("abcde"), batch=2) == \
        jgather.pushshift_comment_times(lambda ids: {i: 1 for i in ids})(list("abcde"), batch=2)


def test_trees_combine_and_prune_match_jax(tmp_path, raw):
    data = tmp_path / "months"
    data.mkdir()
    pd.DataFrame({"id": ["s1", "c2", "c5"], "label": ["DEG", "Neutral", "lti_hate"]}).to_parquet(data / "a-processed.parquet")
    subs = [{"id": "s1", "title": "post", "body": "NA"}, {"id": "s2", "title": "other", "body": "text"}]
    comments = [{"id": f"c{i}", "link_id": "t3_s1" if i < 5 else "t3_s2",
                 "parent_id": "t3_s1" if i in (1, 2) else ("t1_c4" if i == 3 else "t3_s2" if i >= 5 else "t1_c1"),
                 "body": f"comment {i}"} for i in range(1, 8)]
    comments.append({"id": "c9", "link_id": "t3_s9", "parent_id": "t3_s9", "body": "orphan"})
    for name, rows in (("2015-01-submissions.json", subs), ("2015-01-comments.json", comments)):
        (data / name).write_text("".join(json.dumps(r) + "\n" for r in rows))
    got, want = _both(tmp_path, ptrees.combine_months, jtrees.combine_months, str(data), out_path="{d}/complete.json")
    assert got == want
    _same_tree(tmp_path / "port", tmp_path / "jax")
    label_of = {"c2": "DEG"}
    assert ptrees.build_month_trees(subs, comments, label_of) == jtrees.build_month_trees(subs, comments, label_of)
    got, want = _both(tmp_path, ptrees.prune_file, jtrees.prune_file, str(raw), "{d}/pruned.json")
    assert got == want == 25
    _same_tree(tmp_path / "port", tmp_path / "jax")
    with open(raw) as f:
        tree = json.loads(f.readline())
    assert ptrees.count_labels(tree) == jtrees.count_labels(tree)
    assert ptrees.count_size_of_tree(tree) == jtrees.count_size_of_tree(tree)


def test_images_match_jax_with_a_stub_fetcher(tmp_path, raw):
    """Stage 4 over the corpus with imgur URLs in some bodies: the annotated
    JSON and the fetched (stub) images, resized and saved, byte-equal."""
    from io import BytesIO

    from PIL import Image

    src = tmp_path / "with-urls.json"
    with open(raw) as f, open(src, "w") as out:
        for i, line in enumerate(f):
            tree = json.loads(line)
            tree["data"]["url"] = f"https://i.imgur.com/p{i}.jpg" if i % 3 == 0 else "https://example.com/x.png"
            for j, c in enumerate(tree["tree"][:3]):
                c["data"]["body"] += f" https://i.imgur.com/{i}-{j}.png http://other.org/a.gif"
            out.write(json.dumps(tree) + "\n")

    def fetch(url):
        if url.endswith("0.png"):
            return None  # a failed download
        buf = BytesIO()
        Image.new("RGB", (300 + len(url), 120), color=(len(url) % 256, 40, 90)).save(buf, format="PNG")
        return buf.getvalue()

    got, want = _both(tmp_path, pimages.annotate_and_fetch, jimages.annotate_and_fetch, str(src), "{d}/out.json",
                      "{d}", fetch)
    assert got == want > 0
    files = _same_tree(tmp_path / "port", tmp_path / "jax")
    assert any(f.endswith(".png") for f in files)
    assert pimages.parse_images("a http://i.imgur.com/x.jpeg b") == jimages.parse_images("a http://i.imgur.com/x.jpeg b")
    for size in ((512, 128), (100, 400)):
        a, b = pimages.resize_image(Image.new("RGB", size)), jimages.resize_image(Image.new("RGB", size))
        assert a.size == b.size and max(a.size) == 256
    blank = Image.new("RGB", (256, 64))
    buf = BytesIO()
    blank.save(buf, format="PNG")
    for mod in (pimages, jimages):  # a deleted-image fingerprint: not saved
        assert mod.save_image_bytes(buf.getvalue(), "n", str(tmp_path), 0, [list(blank.getdata())]) is None


def test_splits_and_text_export_match_jax(tmp_path, raw):
    got, want = _both(tmp_path, psplits.build_dupe_table, jsplits.build_dupe_table, str(raw), "{d}/duped.parquet")
    assert got == want and got  # the bot text and "[deleted]" repeat
    got, want = _both(tmp_path, psplits.make_splits, jsplits.make_splits, str(raw), "{d}", n_splits=3, seed=2)
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    got, want = _both(tmp_path, pexport.export_splits, jexport.export_splits, str(raw), "{d}", "{d}/export",
                      duped=got and psplits.build_dupe_table(str(raw)), n_splits=3)
    assert got == want > 0
    got, want = _both(tmp_path, pexport.export_splits, jexport.export_splits, str(raw), "{d}", "{d}/labelled",
                      n_splits=1, labelled_only=True)
    assert got == want > 0
    _same_tree(tmp_path / "port", tmp_path / "jax")
    with open(raw) as f:
        tree = json.loads(f.readline())
    assert psplits.tree_has_hate(tree) == jsplits.tree_has_hate(tree)
    assert list(psplits.iter_bodies(tree)) == list(jsplits.iter_bodies(tree))


def test_run_cli_matches_jax(tmp_path, raw, capsys):
    for argv in (["prune", str(raw), "{d}/pruned.json"],
                 ["images", str(raw), "{d}/with-images.json", "--image-root", "{d}"],
                 ["splits", str(raw), "{d}/splits", "--n-splits", "2"],
                 ["export", str(raw), "{d}/splits", "{d}/export", "--duped", "{d}/splits/duped.parquet",
                  "--n-splits", "2"]):
        for name, main in (("port", prun.main), ("jax", jrun.main)):
            d = tmp_path / name
            d.mkdir(exist_ok=True)
            assert main([a.format(d=d) for a in argv]) == 0
        out = capsys.readouterr().out.replace(str(tmp_path / "port"), "D").replace(str(tmp_path / "jax"), "D")
        lines = out.splitlines()
        assert lines[: len(lines) // 2] == lines[len(lines) // 2:], argv
    _same_tree(tmp_path / "port", tmp_path / "jax")


def test_run_splits_without_pandas_writes_json(tmp_path, raw, monkeypatch, capsys):
    """Without pandas (as on the card's machine) ``splits`` writes the same
    duplicated texts as ``duped.json`` and the same split files, and
    ``export --duped duped.json`` reads them."""
    assert jrun.main(["splits", str(raw), str(tmp_path / "jax")]) == 0
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "pandas", None)
        assert prun.main(["splits", str(raw), str(tmp_path / "port")]) == 0
    assert "duped.json" in capsys.readouterr().out
    with open(tmp_path / "port" / "duped.json") as f:
        assert json.load(f) == list(pd.read_parquet(tmp_path / "jax" / "duped.parquet")["text"])
    for f in os.listdir(tmp_path / "jax"):
        if f.endswith(".txt"):
            assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    assert prun.main(["export", str(raw), str(tmp_path / "port"), str(tmp_path / "pe"), "--duped",
                      str(tmp_path / "port" / "duped.json"), "--n-splits", "1"]) == 0
    assert jrun.main(["export", str(raw), str(tmp_path / "jax"), str(tmp_path / "je"), "--duped",
                      str(tmp_path / "jax" / "duped.parquet"), "--n-splits", "1"]) == 0
    _same_tree(tmp_path / "pe", tmp_path / "je")

"""Kubernetes resource-string parsing for cluster submission.

(Manifest building lives in ``client/k8s_submit.py`` — dict manifests
shared by the API-submission and ``--output`` rendering paths.  The YAML
string template that used to live here was superseded by it and removed,
VERDICT r3 #8.)
"""


def parse_volume_string(spec):
    """'claim_name=c1,mount_path=/p1;host_path=/d,mount_path=/p2' ->
    (volumes, volume_mounts) dict manifests.

    Reference semantics (elasticdl_client/common/k8s_volume.py):
    ``;``-separated volume entries of ``,``-separated k=v pairs; a
    ``claim_name`` entry mounts a PersistentVolumeClaim, a
    ``host_path`` entry mounts a host directory; ``mount_path`` is
    required, ``sub_path`` and ``read_only`` optional.  Repeating the
    same claim/host path reuses ONE volume with multiple mounts.
    """
    volumes = []
    mounts = []
    seen = {}  # (type, source) -> volume name

    def _volume_name(kind, source):
        key = (kind, source)
        if key not in seen:
            import zlib

            slug = "".join(
                ch if ch.isalnum() else "-" for ch in source
            ).strip("-").lower() or "root"
            # Distinct sources can collapse to one slug ('data.x' and
            # 'data-x' both -> 'data-x'); a source hash keeps the k8s
            # volume names unique (and the truncation 63-char-safe).
            seen[key] = "%s-%s-%04x" % (
                kind, slug[:40], zlib.crc32(source.encode()) & 0xFFFF)
        return seen[key]

    for entry in (spec or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        fields = {}
        for piece in entry.split(","):
            key, sep, value = piece.strip().partition("=")
            if not sep:
                raise ValueError("bad volume entry %r" % piece)
            fields[key.strip()] = value.strip()
        if "mount_path" not in fields:
            raise ValueError("volume entry %r needs mount_path" % entry)
        if "claim_name" in fields:
            name = _volume_name("pvc", fields["claim_name"])
            volume = {
                "name": name,
                "persistentVolumeClaim": {
                    "claimName": fields["claim_name"],
                    "readOnly": False,
                },
            }
        elif "host_path" in fields:
            name = _volume_name("hostpath", fields["host_path"])
            volume = {
                "name": name,
                "hostPath": {"path": fields["host_path"]},
            }
        else:
            raise ValueError(
                "volume entry %r needs claim_name or host_path" % entry)
        if all(v["name"] != name for v in volumes):
            volumes.append(volume)
        mount = {"name": name, "mountPath": fields["mount_path"]}
        if fields.get("sub_path"):
            mount["subPath"] = fields["sub_path"]
        if fields.get("read_only", "").lower() in ("true", "1", "yes"):
            mount["readOnly"] = True
        mounts.append(mount)
    return volumes, mounts


def parse_resource_string(spec):
    """'cpu=1,memory=4096Mi,google.com/tpu=8' -> k8s resource dict
    (reference: elasticdl_client/common/k8s_resource.py)."""
    out = {}
    for piece in spec.split(","):
        piece = piece.strip()
        if not piece:
            continue
        key, sep, value = piece.partition("=")
        if not sep:
            raise ValueError("bad resource entry %r" % piece)
        out[key.strip()] = value.strip()
    return out

"""IAM management API over the S3 identity config.

Reference: weed/iamapi/iamapi_server.go + iamapi_management_handlers.go.
Speaks the AWS IAM query protocol (form-encoded Action=..., XML replies):
ListUsers, CreateUser, GetUser, DeleteUser, UpdateUser, CreateAccessKey,
DeleteAccessKey, ListAccessKeys, PutUserPolicy, GetUserPolicy,
DeleteUserPolicy, CreatePolicy. Mutations update the shared S3
IdentityAccessManagement in place (hot reload — the reference achieves
the same via the filer-config subscription, auth_credentials_subscribe.go)
and optionally persist to the filer at /etc/iam/identity.json
(iamapi_server.go persists via filer_etc).

The port's copy of seaweedfs_tpu/iam/iam_server.py. Its differences: the
API is served by the port's utils/fastweb, not aiohttp (the port has
none), the actions on a worker thread; the request path, query and
headers reach the SigV4 check as the reference's aiohttp request gives
them. `start` raises OSError when the port cannot be bound, and `stop`
joins the serving thread. It imports no torch. The stored document is the
port's pb/iam_pb2.S3ApiConfiguration proto-JSON, the same file the
reference reads and writes.
"""

from __future__ import annotations

import json
import secrets
import string
import threading
import urllib.parse
import uuid
import xml.etree.ElementTree as ET

from ..utils.log import logger

log = logger("iam")

IAM_XMLNS = "https://iam.amazonaws.com/doc/2010-05-08/"
CONFIG_PATH = "/etc/iam/identity.json"

# statement action <-> identity action (reference
# iamapi_management_handlers.go:46 MapToStatementAction / :69 reverse)
_STATEMENT_TO_IDENTITY = {
    "*": "Admin", "Put*": "Write", "PutBucketAcl": "WriteAcp",
    "Get*": "Read", "GetBucketAcl": "ReadAcp", "List*": "List",
    "Tagging*": "Tagging", "DeleteBucket*": "DeleteBucket",
}
_IDENTITY_TO_STATEMENT = {v: k for k, v in _STATEMENT_TO_IDENTITY.items()}


def _gen_access_key() -> str:
    return "AKIA" + "".join(secrets.choice(string.ascii_uppercase + string.digits)
                            for _ in range(16))


def _gen_secret_key() -> str:
    return "".join(secrets.choice(string.ascii_letters + string.digits + "/+")
                   for _ in range(40))


class IamError(Exception):
    def __init__(self, code: str, message: str, status: int = 400):
        super().__init__(message)
        self.code, self.message, self.status = code, message, status


class IamApiServer:
    def __init__(self, s3_iam, filer_server=None,
                 ip: str = "127.0.0.1", port: int = 8111):
        self.iam = s3_iam  # s3.auth.IdentityAccessManagement, shared
        self.fs = filer_server  # optional persistence target
        self.ip, self.port = ip, port
        self.config: dict = {"identities": []}
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._http_thread: threading.Thread | None = None
        self._load_persisted()
        if not self.config["identities"]:
            self._seed_from_iam()

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def start(self) -> "IamApiServer":
        self._http_thread = threading.Thread(target=self._run_http,
                                             daemon=True,
                                             name=f"iam-{self.port}")
        self._http_ready = threading.Event()
        self._http_error = None
        self._http_thread.start()
        self._http_ready.wait(10)  # port bound before start() returns
        if self._http_error is not None:
            raise OSError(f"iam http {self.url}: {self._http_error}")
        log.info("iam api %s up", self.url)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._http_thread is not None and \
                self._http_thread is not threading.current_thread():
            self._http_thread.join(5)

    def _seed_from_iam(self) -> None:
        """Adopt the gateway's live identities so the first mutation
        doesn't wipe pre-configured credentials (the gateway may have been
        started with an inline iam_config)."""
        seen: dict[str, dict] = {}
        for ident, _secret in self.iam._by_access_key.values():
            entry = seen.setdefault(ident.name, {
                "name": ident.name, "credentials": [],
                "actions": list(ident.actions)})
            for ak, sk in ident.credentials.items():
                if not any(c["accessKey"] == ak
                           for c in entry["credentials"]):
                    entry["credentials"].append(
                        {"accessKey": ak, "secretKey": sk})
        self.config = {"identities": list(seen.values())}

    # -- persistence ---------------------------------------------------------
    # The stored document is iam_pb.S3ApiConfiguration proto-JSON
    # (reference weed/pb/iam.proto serialized at /etc/iam/identity.json):
    # round-tripping through the message enforces the schema on load AND
    # save, so a malformed field fails loudly instead of flowing into the
    # auth path.
    @staticmethod
    def _to_proto(config: dict):
        from google.protobuf import json_format

        from ..pb import iam_pb2 as ipb
        return json_format.ParseDict(config, ipb.S3ApiConfiguration(),
                                     ignore_unknown_fields=True)

    def _load_persisted(self) -> None:
        if self.fs is None:
            return
        try:
            from ..filer.filer import split_path
            d, n = split_path(CONFIG_PATH)
            entry = self.fs.filer.find_entry(d, n)
            if entry is not None:
                data = self.fs.read_entry_bytes(entry)
                doc = json.loads(data)
                self._to_proto(doc)  # schema gate: malformed fails loudly
                # keep the RAW dict: proto round-trips drop empty repeated
                # fields and extension keys (policy_document)
                for ident in doc.get("identities", []):
                    ident.setdefault("credentials", [])
                    ident.setdefault("actions", [])
                doc.setdefault("identities", [])
                self.config = doc
                self.iam.load(self.config)
        except Exception as e:  # noqa: BLE001
            log.warning("iam config load: %s", e)

    def _persist(self) -> None:
        self.iam.load(self.config)
        if self.fs is None:
            return
        try:
            self._to_proto(self.config)  # schema gate before writing
            self.fs.write_file(CONFIG_PATH,
                               json.dumps(self.config, indent=2).encode(),
                               mime="application/json")
        except Exception as e:  # noqa: BLE001
            log.warning("iam config persist: %s", e)

    # -- identity helpers ----------------------------------------------------
    def _ident(self, user: str) -> dict:
        for ident in self.config["identities"]:
            if ident["name"] == user:
                return ident
        raise IamError("NoSuchEntity", f"user {user} not found", 404)

    # -- HTTP ----------------------------------------------------------------
    def _run_http(self) -> None:
        from ..utils import fastweb

        def dispatch(request: fastweb.Request):
            body = request.body
            params = dict(urllib.parse.parse_qsl(body.decode()))
            params.update({k: v for k, v in request.query.items()})
            action = params.get("Action", "")
            try:
                # Admin-gated when the gateway enforces auth (reference
                # iamapi_server.go signs requests through the s3 auth
                # stack); open only when the whole cluster runs open.
                if self.iam.enabled:
                    import hashlib

                    from ..s3.auth import S3Error
                    lower = {k.lower(): v for k, v in request.headers.items()}
                    try:
                        ident = self.iam.authenticate(
                            request.method, request.path,
                            dict(request.query), lower,
                            hashlib.sha256(body).hexdigest())
                    except S3Error as e:
                        raise IamError("AccessDenied", e.message, 403) from e
                    if not ident.allows("Admin", ""):
                        raise IamError("AccessDenied",
                                       "admin action required", 403)
                with self._mu:
                    result = self._do_action(action, params)
                return fastweb.Response(self._xml_ok(action, result),
                                        content_type="application/xml")
            except IamError as e:
                return fastweb.Response(self._xml_err(e), status=e.status,
                                        content_type="application/xml")
            except Exception as e:  # noqa: BLE001
                log.error("iam %s: %r", action, e)
                err = IamError("ServiceFailure", str(e), 500)
                return fastweb.Response(self._xml_err(err), status=500,
                                        content_type="application/xml")

        async def offloaded(request):
            # the actions persist through the filer: off the loop
            import asyncio
            return await asyncio.to_thread(dispatch, request)

        app = fastweb.FastApp()
        app.default(offloaded)
        try:
            fastweb.serve_fast_app(app, self.ip, self.port, self._stop,
                                   logger=log,
                                   ready=getattr(self, "_http_ready", None))
        except BaseException as e:  # noqa: BLE001 — start() reports it
            self._http_error = e
            self._http_ready.set()

    # -- XML -----------------------------------------------------------------
    def _xml_ok(self, action: str, result: ET.Element | None) -> bytes:
        root = ET.Element(f"{action}Response", xmlns=IAM_XMLNS)
        if result is not None:
            root.append(result)
        meta = ET.SubElement(root, "ResponseMetadata")
        ET.SubElement(meta, "RequestId").text = str(uuid.uuid4())
        return (b'<?xml version="1.0" encoding="UTF-8"?>'
                + ET.tostring(root, encoding="utf-8"))

    def _xml_err(self, e: IamError) -> bytes:
        root = ET.Element("ErrorResponse", xmlns=IAM_XMLNS)
        err = ET.SubElement(root, "Error")
        ET.SubElement(err, "Code").text = e.code
        ET.SubElement(err, "Message").text = e.message
        return ET.tostring(root, encoding="utf-8")

    # -- actions -------------------------------------------------------------
    def _do_action(self, action: str, p: dict) -> ET.Element | None:
        fn = getattr(self, f"_a_{action}", None)
        if fn is None:
            raise IamError("InvalidAction", f"unsupported action {action!r}")
        return fn(p)

    def _a_ListUsers(self, p) -> ET.Element:
        res = ET.Element("ListUsersResult")
        users = ET.SubElement(res, "Users")
        for ident in self.config["identities"]:
            m = ET.SubElement(users, "member")
            ET.SubElement(m, "UserName").text = ident["name"]
        ET.SubElement(res, "IsTruncated").text = "false"
        return res

    def _a_CreateUser(self, p) -> ET.Element:
        user = p.get("UserName", "")
        if not user:
            raise IamError("InvalidInput", "missing UserName")
        if any(i["name"] == user for i in self.config["identities"]):
            raise IamError("EntityAlreadyExists", f"user {user} exists", 409)
        self.config["identities"].append(
            {"name": user, "credentials": [], "actions": []})
        self._persist()
        res = ET.Element("CreateUserResult")
        u = ET.SubElement(res, "User")
        ET.SubElement(u, "UserName").text = user
        return res

    def _a_GetUser(self, p) -> ET.Element:
        ident = self._ident(p.get("UserName", ""))
        res = ET.Element("GetUserResult")
        u = ET.SubElement(res, "User")
        ET.SubElement(u, "UserName").text = ident["name"]
        return res

    def _a_UpdateUser(self, p) -> None:
        ident = self._ident(p.get("UserName", ""))
        new = p.get("NewUserName", "")
        if new and new != ident["name"]:
            if any(i["name"] == new for i in self.config["identities"]):
                raise IamError("EntityAlreadyExists",
                               f"user {new} exists", 409)
            ident["name"] = new
            self._persist()
        return None

    def _a_DeleteUser(self, p) -> None:
        ident = self._ident(p.get("UserName", ""))
        self.config["identities"].remove(ident)
        self._persist()
        return None

    def _a_CreateAccessKey(self, p) -> ET.Element:
        ident = self._ident(p.get("UserName", ""))
        ak, sk = _gen_access_key(), _gen_secret_key()
        ident["credentials"].append({"accessKey": ak, "secretKey": sk})
        self._persist()
        res = ET.Element("CreateAccessKeyResult")
        key = ET.SubElement(res, "AccessKey")
        ET.SubElement(key, "UserName").text = ident["name"]
        ET.SubElement(key, "AccessKeyId").text = ak
        ET.SubElement(key, "SecretAccessKey").text = sk
        ET.SubElement(key, "Status").text = "Active"
        return res

    def _a_DeleteAccessKey(self, p) -> None:
        ident = self._ident(p.get("UserName", ""))
        ak = p.get("AccessKeyId", "")
        ident["credentials"] = [c for c in ident["credentials"]
                                if c["accessKey"] != ak]
        self._persist()
        return None

    def _a_ListAccessKeys(self, p) -> ET.Element:
        ident = self._ident(p.get("UserName", ""))
        res = ET.Element("ListAccessKeysResult")
        keys = ET.SubElement(res, "AccessKeyMetadata")
        for c in ident["credentials"]:
            m = ET.SubElement(keys, "member")
            ET.SubElement(m, "UserName").text = ident["name"]
            ET.SubElement(m, "AccessKeyId").text = c["accessKey"]
            ET.SubElement(m, "Status").text = "Active"
        ET.SubElement(res, "IsTruncated").text = "false"
        return res

    # -- policies (mapped onto identity actions, reference GetActions
    # iamapi_management_handlers.go:310) --------------------------------------
    def _a_PutUserPolicy(self, p) -> None:
        ident = self._ident(p.get("UserName", ""))
        try:
            doc = json.loads(p.get("PolicyDocument", "{}"))
        except json.JSONDecodeError as e:
            raise IamError("MalformedPolicyDocument", str(e)) from e
        ident["actions"] = _policy_to_actions(doc)
        ident["policy_document"] = doc
        self._persist()
        return None

    def _a_GetUserPolicy(self, p) -> ET.Element:
        ident = self._ident(p.get("UserName", ""))
        res = ET.Element("GetUserPolicyResult")
        ET.SubElement(res, "UserName").text = ident["name"]
        ET.SubElement(res, "PolicyName").text = p.get("PolicyName", "")
        doc = ident.get("policy_document")
        if doc is None:
            doc = _actions_to_policy(ident.get("actions", []))
        ET.SubElement(res, "PolicyDocument").text = json.dumps(doc)
        return res

    def _a_DeleteUserPolicy(self, p) -> None:
        ident = self._ident(p.get("UserName", ""))
        ident["actions"] = []
        ident.pop("policy_document", None)
        self._persist()
        return None

    def _a_CreatePolicy(self, p) -> ET.Element:
        # standalone managed policies are stored but unattached
        name = p.get("PolicyName", "")
        try:
            json.loads(p.get("PolicyDocument", "{}"))
        except json.JSONDecodeError as e:
            raise IamError("MalformedPolicyDocument", str(e)) from e
        self.config.setdefault("policies", {})[name] = p.get("PolicyDocument")
        self._persist()
        res = ET.Element("CreatePolicyResult")
        pol = ET.SubElement(res, "Policy")
        ET.SubElement(pol, "PolicyName").text = name
        ET.SubElement(pol, "Arn").text = f"arn:aws:iam:::policy/{name}"
        return res


def _policy_to_actions(doc: dict) -> list[str]:
    """Parse Allow statements into identity actions
    (reference GetActions iamapi_management_handlers.go:310)."""
    actions: list[str] = []
    for st in doc.get("Statement", []):
        if st.get("Effect") != "Allow":
            continue
        resources = st.get("Resource", [])
        acts = st.get("Action", [])
        if isinstance(resources, str):
            resources = [resources]
        if isinstance(acts, str):
            acts = [acts]
        for resource in resources:
            res = resource.split(":")
            if len(res) != 6 or res[0] != "arn" or res[2] != "s3":
                continue
            for action in acts:
                svc, _, act = action.partition(":")
                if svc != "s3":
                    continue
                mapped = _STATEMENT_TO_IDENTITY.get(act)
                if mapped is None:
                    continue
                if res[5] == "*":
                    actions.append(mapped)
                    continue
                bucket, slash, rest = res[5].partition("/")
                # bucket-level ARNs ("arn:aws:s3:::bucket", the normal
                # shape for List*) scope like bucket/*
                if not slash or rest == "*":
                    actions.append(f"{mapped}:{bucket}")
    return sorted(set(actions))


def _actions_to_policy(actions: list[str]) -> dict:
    statements = []
    for a in actions:
        act, _, bucket = a.partition(":")
        stmt_action = _IDENTITY_TO_STATEMENT.get(act, act)
        resource = (f"arn:aws:s3:::{bucket}/*" if bucket
                    else "arn:aws:s3:::*")
        statements.append({"Effect": "Allow",
                           "Action": [f"s3:{stmt_action}"],
                           "Resource": [resource]})
    return {"Version": "2012-10-17", "Statement": statements}

"""Port copy of turbo_whisper_workspace_tpu/utils/common_data.py, unchanged.

Shared wordlists for speaker naming and conversation analysis.

Same categories as the reference's vocalis/utils/common_data.py:8-68
(COMMON_NAMES gate for the rule-based speaker identifier, plus phrase
banks for greetings/farewells/agreement/disagreement/questions and
domain terms); the lists themselves are our own.
"""

COMMON_NAMES = {
    # gate for rule-extracted names (llm_helper.py:266 analogue)
    "james", "mary", "john", "patricia", "robert", "jennifer", "michael",
    "linda", "william", "elizabeth", "david", "barbara", "richard", "susan",
    "joseph", "jessica", "thomas", "sarah", "charles", "karen", "chris",
    "christopher", "nancy", "daniel", "lisa", "matthew", "betty", "anthony",
    "margaret", "mark", "sandra", "donald", "ashley", "steven", "kimberly",
    "paul", "emily", "andrew", "donna", "joshua", "michelle", "kenneth",
    "dorothy", "kevin", "carol", "brian", "amanda", "george", "melissa",
    "edward", "deborah", "ronald", "stephanie", "timothy", "rebecca",
    "jason", "sharon", "jeffrey", "laura", "ryan", "cynthia", "jacob",
    "kathleen", "gary", "amy", "nicholas", "angela", "eric", "shirley",
    "jonathan", "anna", "stephen", "brenda", "larry", "pamela", "justin",
    "emma", "scott", "nicole", "brandon", "helen", "benjamin", "samantha",
    "samuel", "katherine", "gregory", "christine", "frank", "debra",
    "alexander", "rachel", "raymond", "carolyn", "patrick", "janet", "jack",
    "catherine", "dennis", "maria", "jerry", "heather", "tyler", "diane",
    "aaron", "ruth", "jose", "julie", "adam", "olivia", "nathan", "joyce",
    "henry", "virginia", "douglas", "victoria", "zachary", "kelly", "peter",
    "lauren", "kyle", "christina", "ethan", "joan", "walter", "evelyn",
    "noah", "judith", "jeremy", "megan", "christian", "andrea", "keith",
    "cheryl", "roger", "hannah", "terry", "jacqueline", "sean", "martha",
    "austin", "gloria", "carl", "teresa", "arthur", "ann", "lawrence",
    "sara", "dylan", "madison", "jesse", "frances", "jordan", "kathryn",
    "bryan", "janice", "billy", "jean", "joe", "abigail", "bruce", "alice",
    "gabriel", "julia", "logan", "judy", "albert", "sophia", "willie",
    "grace", "alan", "denise", "juan", "amber", "wayne", "doris", "elijah",
    "marilyn", "randy", "danielle", "roy", "beverly", "vincent", "isabella",
    "ralph", "theresa", "eugene", "diana", "russell", "natalie", "bobby",
    "brittany", "mason", "charlotte", "philip", "marie", "louis", "kayla",
    "alex", "alexandra", "veronica", "max", "sam", "ben", "tom", "mike",
    "dave", "dan", "jim", "bob", "bill", "steve", "tony", "nick", "luke",
    "liam", "mia", "zoe", "chloe", "ella", "lily", "leo", "owen", "caleb",
}

GREETING_PHRASES = [
    "hello", "hi", "hey", "good morning", "good afternoon", "good evening",
    "howdy", "what's up", "how are you", "how's it going", "nice to meet you",
    "welcome", "greetings",
]

FAREWELL_PHRASES = [
    "goodbye", "bye", "see you", "see ya", "take care", "later",
    "talk to you later", "have a good one", "good night", "farewell",
    "catch you later", "so long",
]

AGREEMENT_PHRASES = [
    "yes", "yeah", "yep", "sure", "absolutely", "definitely", "of course",
    "right", "exactly", "agreed", "sounds good", "okay", "ok", "certainly",
    "that works", "makes sense",
]

DISAGREEMENT_PHRASES = [
    "no", "nope", "nah", "i disagree", "not really", "i don't think so",
    "absolutely not", "no way", "that's wrong", "i'm not sure about that",
    "doubt it",
]

QUESTION_STARTERS = [
    "what", "who", "where", "when", "why", "how", "which", "whose",
    "can you", "could you", "would you", "will you", "do you", "did you",
    "is it", "are you", "have you",
]

AUDIO_TERMS = [
    "microphone", "mic", "speaker", "volume", "echo", "feedback", "static",
    "noise", "recording", "audio", "sound", "mute", "unmute", "gain",
    "distortion", "reverb",
]

TECH_TERMS = [
    "computer", "laptop", "phone", "software", "hardware", "app",
    "application", "internet", "wifi", "network", "server", "database",
    "email", "website", "browser", "update", "install", "download",
    "upload", "backup", "cloud", "login", "password",
]
